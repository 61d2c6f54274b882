"""Copies of ``midi_vae_tpu/utils/music.py`` and ``plotting.py``."""
