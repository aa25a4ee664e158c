"""Host utilities: WAV I/O, metrics, logging, tracing, plots."""
