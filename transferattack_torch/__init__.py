"""transferattack_torch: the PyTorch/CUDA port of ``transferattack_tpu``.

Same registry contract as the JAX package: a string key maps to
``(module path, class name)``, resolved lazily.  Keys appear here as their
attacks land in the port.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

__version__ = "0.1.0"

attack_zoo: Dict[str, Tuple[str, str]] = {
    "fgsm": (".gradient.mifgsm", "FGSM"),
    "ifgsm": (".gradient.mifgsm", "IFGSM"),
    "mifgsm": (".gradient.mifgsm", "MIFGSM"),
    "nifgsm": (".gradient.mifgsm", "NIFGSM"),
    "pifgsm": (".gradient.pifgsm", "PIFGSM"),
    "vmifgsm": (".gradient.vmifgsm", "VMIFGSM"),
    "vnifgsm": (".gradient.vmifgsm", "VNIFGSM"),
    "emifgsm": (".gradient.emifgsm", "EMIFGSM"),
    "aifgtm": (".gradient.aifgtm", "AIFGTM"),
    "ifgssm": (".gradient.ifgssm", "IFGSSM"),
    "smifgrm": (".gradient.smifgrm", "SMIFGRM"),
    "vaifgsm": (".gradient.vaifgsm", "VAIFGSM"),
    "rap": (".gradient.rap", "RAP"),
    "pcifgsm": (".gradient.iefgsm", "PCIFGSM"),
    "iefgsm": (".gradient.iefgsm", "IEFGSM"),
    "gra": (".gradient.gra", "GRA"),
    "gnp": (".gradient.iefgsm", "GNP"),
    "mig": (".gradient.mig", "MIG"),
    "dta": (".gradient.dta", "DTA"),
    "pgn": (".gradient.pgn", "PGN"),
    "mef": (".gradient.mef", "MEF"),
    "gifgsm": (".gradient.gifgsm", "GIFGSM"),
    "rgmifgsm": (".gradient.tricks", "RGMIFGSM"),
    "dual_mifgsm": (".gradient.tricks", "DualMIFGSM"),
    "ens_mifgsm": (".gradient.tricks", "Ens_FGSM_MIFGSM"),
    "fgsra": (".gradient.fgsra", "FGSRA"),
    "gaa": (".gradient.gaa", "GAA"),
    "foolmix": (".gradient.foolmix", "Foolmix"),
    "adamsi_fgm": (".gradient.adamsi_fgm", "AdaMSI_FGM"),
    "anda": (".gradient.anda", "ANDA"),
    "mumodig": (".gradient.mumodig", "MUMODIG"),
    "dim": (".input_transformation.dim", "DIM"),
    "dem": (".input_transformation.dim", "DEM"),
    "tim": (".input_transformation.tim", "TIM"),
    "sim": (".input_transformation.sim", "SIM"),
    "admix": (".input_transformation.sim", "Admix"),
    "usmm": (".input_transformation.sim", "USMM"),
    "ssm": (".input_transformation.ssm", "SSM"),
    "maskblock": (".input_transformation.maskblock", "MaskBlock"),
    "sia": (".input_transformation.sia", "SIA"),
    "bsr": (".input_transformation.bsr", "BSR"),
    "mfi": (".input_transformation.mfi", "MFI"),
    "decowa": (".input_transformation.decowa", "DeCowA"),
    "ops": (".input_transformation.ops_attack", "OPS"),
    "su": (".input_transformation.su", "SU"),
    "l2t": (".input_transformation.l2t", "L2T"),
    "ssm_h": (".input_transformation.ssm_tricks", "SSM_H"),
    "ssm_p": (".input_transformation.ssm_tricks", "SSM_P"),
    "tap": (".advanced_objective.tap", "TAP"),
    "ila": (".advanced_objective.ila", "ILA"),
    "fia": (".advanced_objective.fia", "FIA"),
    "rpa": (".advanced_objective.fia", "RPA"),
    "fmaa": (".advanced_objective.fia", "FMAA"),
    "bfa": (".advanced_objective.fia", "BFA"),
    "naa": (".advanced_objective.naa", "NAA"),
    "danaa": (".advanced_objective.naa", "DANAA"),
    "taig": (".advanced_objective.taig", "TAIG"),
    "fuzziness_tuned": (".advanced_objective.tap", "Fuzziness_Tuned"),
    "ilpd": (".advanced_objective.ila", "ILPD"),
    "logit": (".advanced_objective.logit", "LOGIT"),
    "logit_margin": (".advanced_objective.logit", "Logit_Margin"),
    "potrip": (".advanced_objective.logit", "POTRIP"),
    "aa": (".advanced_objective.aa", "AA"),
    "ir": (".advanced_objective.ir", "IR"),
    "p2fa": (".advanced_objective.ir", "P2FA"),
    "trap": (".advanced_objective.ir", "TRAP"),
    "ata": (".advanced_objective.cfm", "ATA"),
    "mfaa": (".advanced_objective.cfm", "MFAA"),
    "yaila": (".advanced_objective.cfm", "YAILA"),
    "cfm": (".advanced_objective.cfm", "CFM"),
    "ftm": (".advanced_objective.cfm", "FTM"),
    "fft": (".advanced_objective.cfm", "FFT"),
    "sgm": (".model_related.sgm", "SGM"),
    "linbp": (".model_related.sgm", "LinBP"),
    "iaa": (".model_related.sgm", "IAA"),
    "bpa": (".model_related.sgm", "BPA"),
    "ghost": (".model_related.sgm", "GhostNetwork_MIFGSM"),
    "dhf": (".model_related.dhf", "DHF_MIFGSM"),
    "mup": (".model_related.weight_attacks", "MUP"),
    "awt": (".model_related.weight_attacks", "AWT"),
    "faug": (".model_related.weight_attacks", "FAUG"),
    "dra": (".model_related.checkpoint_surrogates", "DRA"),
    "mta": (".model_related.checkpoint_surrogates", "MTA"),
    "dsm": (".model_related.checkpoint_surrogates", "DSM"),
    "ags": (".model_related.checkpoint_surrogates", "AGS"),
    "ma": (".model_related.checkpoint_surrogates", "MA"),
    "ana": (".model_related.checkpoint_surrogates", "ANA"),
    "qaa": (".model_related.checkpoint_surrogates", "QAA"),
    "metassa": (".model_related.metassa", "MetaSSA"),
    "llta": (".model_related.llta", "LLTA"),
    "tgr": (".model_related.vit_attacks", "TGR"),
    "pna_patchout": (".model_related.vit_attacks", "PNA_PatchOut"),
    "sapr": (".model_related.vit_attacks", "SAPR"),
    "fdap": (".model_related.vit_attacks", "FDAP"),
    "vdc": (".model_related.vit_attacks2", "VDC"),
    "fpr": (".model_related.vit_attacks2", "FPR"),
    "att": (".model_related.vit_attacks2", "ATT"),
    "setr": (".model_related.vit_attacks2", "SETR"),
    "ll2s": (".model_related.llta", "LL2S"),
    "ata_vit": (".model_related.llta", "ATA_ViT"),
}


def load_attack_class(attack_name: str):
    """Resolve a registry key to its attack class."""
    if attack_name not in attack_zoo:
        raise ValueError(f"Unsupported attack {attack_name!r}")
    module_path, class_name = attack_zoo[attack_name]
    module = importlib.import_module(module_path, package=__name__)
    return getattr(module, class_name)
