"""A run of each cell on the CPU at a small size, with the program's timed
path broken underneath: the check comes out false for each fault the cell
can have, and true with none.  (The look for a card is the entry point's,
``run.main``; ``bench.run`` is the rest of a run.)"""
import pytest
import torch

from gpubench import bench
from gpubench.small import small_cell

SEED = 2**31 + 77


def _alter_token(real):
    """The best logit's token moved one id up, where the logits are made."""
    def prefill(model, batch, cache_len=None):
        logits, state = real(model, batch, cache_len)
        logits = logits.clone()
        logits[torch.arange(len(logits)), (logits.argmax(-1) + 1) % logits.shape[-1]] += 1e3
        return logits, state
    return prefill


def _alter_step_token(real):
    def serve_step(model, state, token):
        logits, new = real(model, state, token)
        logits = logits.clone()
        logits[torch.arange(len(logits)), (logits.argmax(-1) + 1) % logits.shape[-1]] += 1e3
        return logits, new
    return serve_step


def _half_batch(real):
    """Rows past the first half left out: their logits the mean of the rest."""
    def fn(*args, **kw):
        logits, state = real(*args, **kw)
        logits = logits.clone()
        half = len(logits) // 2
        logits[half:] = logits[:half].mean(dim=0)
        return logits, state
    return fn


def _state_unchanged(real):
    """A decode step that hands back the state it was given."""
    def serve_step(model, state, token):
        logits, _ = real(model, state, token)
        return logits, state
    return serve_step


def _weights_changed(real):
    """A program that rewrites a weight in place (the reference would read
    the rewritten weight and agree with it)."""
    def prefill(model, batch, cache_len=None):
        model.layers[0].mixer.wo.mul_(1.5)
        return real(model, batch, cache_len)
    return prefill


FAULTS = {
    "grok1-prefill": {"token_altered": ("prefill", _alter_token), "weights_changed": ("prefill", _weights_changed)},
    "internvl2-prefill": {"token_altered": ("prefill", _alter_token), "half_batch": ("prefill", _half_batch)},
    "grok1-decode": {"token_altered": ("serve_step", _alter_step_token), "half_batch": ("serve_step", _half_batch),
                     "state_unchanged": ("serve_step", _state_unchanged)},
}
CASES = [(cell, f) for cell, faults in FAULTS.items() for f in [None, *faults]]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.models import model as M

    if fault:
        name, wrap = FAULTS[cell][fault]
        monkeypatch.setattr(M, name, wrap(getattr(M, name)))
    line, _, readings = bench.run(small_cell(cell), SEED, 1e-6, False, device="cpu")  # one batch
    assert line["correct"] is (fault is None), readings
    assert list(line)[-1] == "checks" and line["attempted"] > 0
