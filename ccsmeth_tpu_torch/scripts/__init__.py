"""Command-line scripts of the port that reach a model, run as
``python -m ccsmeth_tpu_torch.scripts.<name>``."""
