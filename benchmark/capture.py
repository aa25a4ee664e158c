"""Taps on the program's kernel entries, installed from the benchmark's own
files at the name each caller looks an entry up by, so the program is not
edited.

A tap passes every call through. It keeps a sample of the calls drawn from
the run's seed (a reservoir over all calls of the window), with copies of
their inputs and outputs, for the comparison with the reference after the
window; in a traced run it also records every call's argument shapes for
the roofline. A call that is not kept costs one Python call and, traced,
one list append.
"""

from __future__ import annotations

import inspect
import random

import torch


def _copy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    return v


def _shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else v


class Tap:
    def __init__(self, owner, attr: str, keep: int, rng: random.Random, shapes: bool):
        self.owner, self.attr = owner, attr
        self.inner = getattr(owner, attr)
        self.sig = inspect.signature(self.inner)
        self.keep, self.rng = keep, rng
        self.calls = 0
        self.kept: list[tuple[dict, dict]] = []  # (arguments by name, outputs)
        self.shapes: list[dict] | None = [] if shapes else None
        self.record = shapes
        setattr(owner, attr, self)

    def __call__(self, *args, **kwargs):
        out = self.inner(*args, **kwargs)
        self.calls += 1
        slot = len(self.kept) if len(self.kept) < self.keep else (
            self.rng.randrange(self.calls) if self.keep else self.keep)
        if not self.record and slot >= self.keep:
            return out
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        named = bound.arguments
        if self.record:
            self.shapes.append({k: _shape(v) for k, v in named.items()})
        if slot < self.keep:
            kept = (_copy(dict(named)), _copy(out))
            if slot == len(self.kept):
                self.kept.append(kept)
            else:
                self.kept[slot] = kept
        return out

    def close(self) -> None:
        setattr(self.owner, self.attr, self.inner)


class Taps:
    """Several taps, installed together and removed together; none at all
    where they would keep and record nothing (an untraced decode loop)."""

    def __init__(self, seed: int, keep: int, shapes: bool, targets: dict):
        self.rng = random.Random(seed)
        self.keep, self.record, self.targets = keep, shapes, targets
        self.by_name: dict[str, Tap] = {}

    def __enter__(self):
        if not self.keep and not self.record:  # nothing to keep or record: the entries stay as they are
            return self
        for name, (owner, attr) in self.targets.items():
            self.by_name[name] = Tap(owner, attr, self.keep, self.rng, self.record)
        return self

    def __exit__(self, *exc):
        for tap in self.by_name.values():
            tap.close()
        return False

    def shapes(self) -> dict:
        return {k: t.shapes for k, t in self.by_name.items() if t.shapes is not None}

    def stop_shapes(self) -> None:
        """Record no further call's shapes (the traced slice has ended)."""
        for tap in self.by_name.values():
            tap.record = False
