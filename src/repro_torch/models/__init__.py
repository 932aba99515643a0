"""The model zoo on PyTorch (the port of ``repro.models``)."""
from .lm import Model, causal_lm_loss
