"""Spectrogram utilities of the port (``vits_tpu/utils`` counterparts)."""
