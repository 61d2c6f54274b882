"""The data pipeline: copies of ``midi_vae_tpu/data`` (smf, tensorize, dataset,
batching) that import nothing of the JAX package."""
