"""Model-specific collectives (port of ``paddle_tpu/distributed/models``)."""
