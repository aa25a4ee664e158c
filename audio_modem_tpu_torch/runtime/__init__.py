"""Streaming runtime: ring buffer, receiver FSM, chunk assembly, live PCM
ingest and audio devices."""
