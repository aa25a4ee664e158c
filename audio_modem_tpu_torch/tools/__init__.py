"""Drivers that run the port at config-5 scale (``python -m
audio_modem_tpu_torch.tools.<name>``): the soak, the lossy-channel ARQ soak
and the host consume microbench."""
