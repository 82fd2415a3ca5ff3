"""Command-line benches of the port, run with ``python -m transferattack_torch.scripts.<name>``."""
