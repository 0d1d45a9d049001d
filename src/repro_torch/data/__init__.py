"""The deterministic data pipeline of the port: copies of `repro.data`'s
numpy modules (synthetic corpus, packing, host sharding, imbalance
generators)."""

from . import imbalance, packing, sharding, synthetic

__all__ = ["imbalance", "packing", "sharding", "synthetic"]
