"""Artifact manifest (counterpart of the JAX package's ``utils/weights_manifest.py``).

Every external checkpoint family the attacks and defenses can consume: the
reference pulls its weights from torchvision/timm, per-attack releases,
HuggingFace and figshare; with no network they are fetched by hand and
converted explicitly.  Each entry maps one expected
``$TA_TPU_WEIGHTS_DIR/<npz>.npz`` to its upstream source file, the module the
weights load into and the conversion recipe.  The npz is the JAX package's
flat layout, so one file serves both packages.  Use:

    python -m transferattack_torch.utils.convert --list
    python -m transferattack_torch.utils.convert --all <download_dir>
    python -m transferattack_torch.utils.convert <name> <path.pth>

``--all`` scans a directory of downloaded originals, converts every file it
recognizes, and prints a per-family status table.

Runtime fallback registry: every loader that substitutes a seeded random
init for a missing artifact calls :func:`record_fallback`, and the CLI writes
the accumulated set into ``attack_meta.json`` and ``results_eval.jsonl``, so
no run passes off random-weight outputs as meaningful.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Sequence, Tuple

# ---------------------------------------------------------------------------
# runtime fallback registry
# ---------------------------------------------------------------------------

_FALLBACKS: set = set()


def record_fallback(name: str) -> None:
    """Note that artifact ``name`` was unavailable and a seeded random init
    ran in its place."""
    _FALLBACKS.add(str(name))


def fallback_weights_used() -> List[str]:
    """Sorted list of the artifacts that fell back to a random init in this
    process."""
    return sorted(_FALLBACKS)


def reset_fallbacks() -> None:
    _FALLBACKS.clear()


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Artifact:
    npz: str                     # expected $TA_TPU_WEIGHTS_DIR/<npz>.npz
    source: str                  # upstream filename (or glob) to download
    origin: str                  # where the reference obtains it
    target: str                  # module the weights load into
    recipe: str                  # conversion entry point / notes
    used_by: Sequence[str] = ()  # attack/defense registry keys


MANIFEST = (
    # -- torchvision/timm surrogates (the 8 paper eval models + extras) ----
    *[
        Artifact(
            npz=n, source=f"{n}.pth",
            origin="torchvision/timm pretrained (reference attack.py:51-60)",
            target=f"models.make_model('{n}')",
            recipe="convert_and_save(name, pth)",
            used_by=("all attacks", "--eval"),
        )
        for n in ("resnet18", "resnet50", "resnet101", "resnet152", "vgg16",
                  "vgg19", "mobilenet_v2", "inception_v3",
                  "inception_resnet_v2", "densenet121", "resnext101_32x4d",
                  "vit_base_patch16_224", "pit_b_224", "visformer_small",
                  "swin_tiny_patch4_window7_224", "cait_s24_224",
                  "deit_base_distilled_patch16_224")
    ],
    # -- alternate checkpoint surrogates (model_related) --------------------
    Artifact("dra_resnet50", "DRA_resnet50.pth",
             "github.com/alibaba/easyrobust (dra.py docstring)",
             "models.make_model('resnet50')", "convert_and_save", ("dra",)),
    Artifact("mta_resnet18", "MTA_stage3.pth", "MTA release (mta.py)",
             "models.make_model('resnet18')", "convert_and_save", ("mta",)),
    Artifact("dsm_resnet18", "SD_resnet18_cutmix.pth.tar",
             "DSM release (dsm.py:48-51)",
             "models.make_model('resnet18')", "convert_and_save", ("dsm",)),
    Artifact("ags_coco", "coco_ags_100.pth",
             "AGS release (ags.py:47-52; also ags_comics/ags_paintings)",
             "SSL resnet50 trunk (Basic_SSL_Model.f)", "convert_and_save",
             ("ags",)),
    Artifact("ma_resnet50", "ma_witness.pth", "MA release (ma.py)",
             "models.make_model('resnet50')", "convert_and_save", ("ma",)),
    Artifact("ana_alignment", "aligned_res50_v3.pth",
             "ANA release (ana.py:105-112)",
             "checkpoint_surrogates.AlignmentNet (trunk = plain resnet50)",
             "convert_aux: 'alignment_state_dict' subtree", ("ana",)),
    Artifact("qaa_resnet50", "qaa_apot_resnet50.pth", "QAA release (qaa.py)",
             "checkpoint_surrogates.QAA fake-quant ResNet",
             "convert_and_save", ("qaa",)),
    Artifact("sasd_resnet50", "sasd_ws_resnet50.pth", "SASD-WS release",
             "models.make_model('resnet50')", "convert_and_save", ("sasd_ws",)),
    Artifact("lgv_resnet50_<i>", "lgv/cSGD_*.pt (collection)",
             "figshare LGV weight collection (lgv.py:41-60)",
             "models.make_model('resnet50') ×N",
             "convert each file → lgv_resnet50_<i>.npz", ("lgv",)),
    Artifact("mba_resnet50_<i>", "mba/finetuned_*.pt (collection)",
             "MBA Bayesian-finetuned set (mba.py)",
             "models.make_model('resnet50') ×N",
             "convert each file → mba_resnet50_<i>.npz", ("mba",)),
    # -- learned input-transformation auxiliaries ---------------------------
    Artifact("atta_model", "atta_model_weight.pth",
             "ATTA Google Drive (atta.py:44-49)",
             "input_transformation.learned.ATTAModel",
             "strip the Sequential '1.' prefix then convert "
             "(tests/test_auxnet_parity.py)", ("atta",)),
    Artifact("pam_semantic_predictor", "semantic_predictor.pth",
             "PAM checkpoints dir (pam.py:136-151); also trainable in-framework "
             "via PAM.train_sp",
             "input_transformation.learned.SemanticPredictor",
             "convert_and_save-style (test_auxnet_parity)", ("pam",)),
    Artifact("stm_stylenet", "checkpoint_transformer.pth",
             "STM Google Drive (stm.py:259-266)",
             "input_transformation.learned.StyleNet (Ghiasi)",
             "state_dict_ghiasi subtree → layers_N names", ("stm",)),
    Artifact("stm_embeddings", "checkpoint_embeddings.pth",
             "STM Google Drive (stm.py:260)",
             "STM style distribution (pbn mean + A=U·diag(√s))",
             "SVD of pbn_embedding_covariance → npz{pbn_embedding_mean, A}",
             ("stm",)),
    Artifact("aitl_encoder", "encoder_params.pth", "AITL Google Drive",
             "input_transformation.learned.AITLEncoder", "convert", ("aitl",)),
    Artifact("aitl_decoder", "decoder_params.pth", "AITL Google Drive",
             "input_transformation.learned.AITLDecoder", "convert", ("aitl",)),
    Artifact("aitl_predictor", "predictor_params.pth", "AITL Google Drive",
             "input_transformation.learned.AITLPredictor",
             "rename backbone.classifier → backbone.classifier.1, convert",
             ("aitl",)),
    # -- generation attack generators (HuggingFace TransferAttack repo) -----
    Artifact("ttp_resnet50_<cls>", "ttp/netG_*_<cls>.pth", "HF TransferAttack",
             "generation.ttp GeneratorResnet ×10 target classes",
             "convert per class", ("ttp",)),
    Artifact("m3d_resnet50_<cls>", "m3d/netG_*_<cls>.pth", "HF TransferAttack",
             "generation GeneratorResnet ×10", "convert per class", ("m3d",)),
    Artifact("cdtp", "cdtp/netG_*.pth", "HF TransferAttack (per domain)",
             "generation GeneratorResnet", "convert", ("cdtp",)),
    Artifact("ltp", "ltp/netG_*.pth", "HF TransferAttack",
             "generation GeneratorResnet", "convert", ("ltp",)),
    Artifact("ada", "ada/generator.pth", "HF TransferAttack",
             "generation UNet AttackGenerator", "convert", ("ada",)),
    Artifact("ge_advgan", "ge_advgan/netG.pth", "HF TransferAttack",
             "generation AdvGAN generator", "convert", ("ge_advgan",)),
    Artifact("dsva", "dsva/generator.pth", "HF TransferAttack",
             "generation GeneratorResnet", "convert", ("dsva",)),
    Artifact("fap", "fap/netG.pth", "HF TransferAttack",
             "generation GeneratorResnet", "convert", ("fap",)),
    Artifact("aim_resnet50", "aim/generator.pth + aim_related/*.JPEG",
             "HF TransferAttack + in-repo guide images",
             "generation.aim ResNetGenerator (EnhancedBN)",
             "convert; guide JPEGs copied to $TA_TPU_WEIGHTS_DIR/aim_guides",
             ("aim",)),
    Artifact("rfcoa_ae + rfcoa_feat_<cls>", "ensemble/rfcoa/{24..919}.npz + AE",
             "in-repo robust features (rfcoa)", "ensemble.rfcoa",
             "copy npz per class; AE via convert", ("rfcoa",)),
    Artifact("sd_unet", "unet/diffusion_pytorch_model.bin (SD-1.5/2-base)",
             "HF stable-diffusion (diffattack.py:27-32)",
             "generation.sd_unet.SDUNet",
             "convert_sd('sd_unet', bin) (tests/test_sd_parity.py)",
             ("diffattack",)),
    Artifact("sd_vae", "vae/diffusion_pytorch_model.bin",
             "HF stable-diffusion (diffattack.py:27-32)",
             "generation.sd_vae.SDVAE",
             "convert_sd('sd_vae', bin)", ("diffattack",)),
    Artifact("sd_text", "text_encoder/pytorch_model.bin",
             "HF stable-diffusion CLIP text tower (diffattack.py:27-32)",
             "generation.sd_text.CLIPTextEncoder",
             "convert_sd('sd_text', bin)", ("diffattack",)),
    Artifact("clip_vocab + clip_merges", "tokenizer/{vocab.json,merges.txt}",
             "HF stable-diffusion tokenizer (diffattack.py:759 TextLabel)",
             "generation.sd_text.SDTokenizer",
             "copy to $TA_TPU_WEIGHTS_DIR/clip_{vocab.json,merges.txt}",
             ("diffattack",)),
    # -- defenses ------------------------------------------------------------
    Artifact("at_resnet50_4px", "imagenet_model_weights_4px.pth.tar",
             "fast-AT release (defense/README.md)",
             "models.make_model('resnet50')", "convert_and_save", ("AT",)),
    Artifact("hgd_resnet152", "denoise_res_015.ckpt", "HGD release",
             "defense.at.DUNet + resnet152", "defense.at.convert_hgd",
             ("HGD",)),
    Artifact("hgd_inception_resnet_v2", "denoise_inres_014.ckpt", "HGD release",
             "defense.at.DUNet + inception_resnet_v2", "defense.at.convert_hgd",
             ("HGD",)),
    Artifact("hgd_inception_v3", "denoise_incepv3_012.ckpt", "HGD release",
             "defense.at.DUNet + inception_v3", "defense.at.convert_hgd",
             ("HGD",)),
    Artifact("hgd_resnext101_32x4d", "denoise_rex_001.ckpt", "HGD release",
             "defense.at.DUNet + resnext101_32x4d", "defense.at.convert_hgd",
             ("HGD",)),
    Artifact("rs_resnet50_sigma050", "noise_0.50/checkpoint.pth.tar",
             "randomized-smoothing release (defense/README.md)",
             "models.make_model('resnet50')", "convert_and_save", ("RS",)),
    Artifact("nrp", "NRP.pth", "NRP release (defense/README.md)",
             "defense.nrp.NRP (RRDB 3,3,64,23)", "convert_and_save-style",
             ("NRP",)),
    Artifact("diffpure_unet", "256x256_diffusion_uncond.pt",
             "guided-diffusion release (defense/README.md)",
             "defense.gd_unet.GuidedDiffusionUNet",
             "torch_state_dict_to_flax(prefix='') → reconcile "
             "(tests/test_gd_unet_parity.py)", ("DiffPure",)),
)


def weights_root() -> str:
    """``$TA_TPU_WEIGHTS_DIR``, else ``./weights``."""
    return os.environ.get("TA_TPU_WEIGHTS_DIR", os.path.join(os.getcwd(), "weights"))


def status() -> List[Tuple[Artifact, bool]]:
    """``[(artifact, present)]`` for every manifest entry (a collection or
    per-class entry counts as present if any of its files is)."""
    root = weights_root()
    out = []
    for art in MANIFEST:
        pat = art.npz.replace("<i>", "*").replace("<cls>", "*").split(" ")[0]
        out.append((art, bool(glob.glob(os.path.join(root, f"{pat}.npz")))))
    return out


def print_inventory() -> None:
    rows = status()
    present = sum(1 for _, ok in rows if ok)
    print(f"# weights manifest — {present}/{len(rows)} artifact families "
          f"present in {weights_root()}")
    for art, ok in rows:
        mark = "✓" if ok else "✗"
        print(f" {mark} {art.npz:34s} ← {art.source:42s} [{', '.join(art.used_by)}]")
        if not ok:
            print(f"     origin: {art.origin}")
            print(f"     recipe: {art.recipe}")
