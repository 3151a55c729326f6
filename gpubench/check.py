"""Whether what the timed path produced is correct.

After the window a sample of the rows it finished, drawn from the seed
with the longest among them, goes through the configuration's plain
reference (``refs/<config["reference"]>.py``) on the same inputs: the
prompt with every token the program served fed back, as the program's
cache held them.  At each served token the judge reads:

* ``gap``: how far the reference's logit of the served token lies below
  its best logit (0 where they pick the same token); greedy decoding is
  correct to the extent this is small;
* ``logit_err``: where the program returned the logits (a prefill's last
  position), the largest gap between the program's and the reference's
  logits over the vocabulary, over the root mean square of the
  reference's.

Where the reference admits several routings (``refs/decoder.py``), each
reading is the one of the admissible path that fits best.  ``gap_max``
and ``logit_err_max`` are the largest readings over the sample; each is
held to its limit in ``limits/<cell>.json``.  A row whose logits were
not finite has failed.  The control (the reference in float8, in the
program's place) is judged the same way: its served token at each
position is its own best logit.
"""
from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from gpubench.spec import sub_seed


class Served(NamedTuple):
    batch: int  # the batch's index in the schedule
    row: int
    positions: int  # prefill positions (prefix and text)
    tokens: List[int]  # the tokens served: the prefill's, then each decode step's
    logits: Optional[torch.Tensor]  # [V] the prefill's logits of this row


def sample(finished: Sequence[Served], n: int, seed: int) -> List[Served]:
    """``n`` rows: the longest (the first of them), and the others drawn
    from the seed."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: (finished[i].positions, -i))
    rest = [s for i, s in enumerate(finished) if i != longest]
    random.Random(sub_seed(seed, "sample")).shuffle(rest)
    return [finished[longest]] + rest[:max(0, n - 1)]


def rows_for(ref, rows: Sequence[Served], inputs_of) -> list:
    """The reference's rows (``ref.row``): each sampled row's inputs
    (``inputs_of(batch)`` gives the batch's drawn inputs) with the served
    tokens but the last fed back, compared at the last prompt position and
    every decode position."""
    return [ref.row(inputs_of(s.batch), s.row, s.tokens, s.positions) for s in rows]


def judge(results, served: Sequence[Sequence[int]], program: Sequence[Optional[torch.Tensor]]) -> Dict:
    """Readings of the served tokens (``served[r][i]`` at row r's compared
    index i) and of the program's logits at compared index 0, against the
    reference's ``results``."""
    gaps, errs, worst = [], [], []
    for r, (res, toks, prog) in enumerate(zip(results, served, program)):
        alts: Dict[int, List[torch.Tensor]] = {}
        for i, lg in res.alternatives:
            alts.setdefault(i, []).append(lg)
        row = []
        for i, t in enumerate(toks):
            cands = [res.logits[i]] + alts.get(i, [])
            row.append(min(float(c.max() - c[t]) for c in cands))
            worst.append((row[-1], r, i, float(res.margins[i]), len(cands)))
        gaps.append(row)
        if prog is not None:
            cands = [res.logits[0]] + alts.get(0, [])
            p = prog.float().to(res.logits.device)
            errs.append(min(float((p - c).abs().max() / c.pow(2).mean().sqrt()) for c in cands))
    readings = {"gap_max": max((g for row in gaps for g in row), default=0.0),
                "tokens_compared": sum(len(row) for row in gaps),
                "row_gap_max": [max(row, default=0.0) for row in gaps],
                "worst": [list(w) for w in sorted(worst, reverse=True)[:6]]}
    if errs:
        readings["logit_err_max"] = max(errs)
        readings["row_logit_err"] = errs
    return readings


def verdict(readings: Dict, limits: Dict[str, float], failed: int) -> Tuple[bool, Dict]:
    """(correct, {name: {value, limit}}): every limited reading within its
    limit, something compared, no row failed and the weights as drawn."""
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    checks["failed_rows"] = {"value": failed, "limit": 0}
    checks["weights_changed"] = {"value": readings.get("weights_changed", 0), "limit": 0}
    ok = readings.get("tokens_compared", 0) > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
