"""Streaming runtime: ring buffer, receiver FSM, chunk assembly."""
