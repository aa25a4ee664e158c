"""Runnable examples of the port (``python -m audio_modem_tpu_torch.examples.demo``)."""
