"""Learned models (port of camkifu_tpu.models): the neural stone
classifier and its trainer."""
