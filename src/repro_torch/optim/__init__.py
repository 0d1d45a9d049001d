"""Optimizers of the port: AdamW with fp32 state (`adamw`) and
error-feedback int8 gradient compression (`grad_compress`), the
counterparts of `repro.optim`."""

from . import adamw, grad_compress

__all__ = ["adamw", "grad_compress"]
