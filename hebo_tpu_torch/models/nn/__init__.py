"""Neural-network surrogates (port of ``hebo_tpu/models/nn``)."""
