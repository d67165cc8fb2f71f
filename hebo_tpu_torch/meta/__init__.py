"""Meta-BO surrogates (port of ``hebo_tpu/meta``); importing this package
registers the ``nap`` model."""

from .nap import NAPSurrogate, TransformerNP, meta_train_np, nap_from_flax, sample_gp_tasks

__all__ = ["NAPSurrogate", "TransformerNP", "meta_train_np", "nap_from_flax", "sample_gp_tasks"]
