"""The plain reference of this benchmark's decoder-only transformers:
grok-1's MoE blocks and InternLM2's dense blocks behind a VLM prefix, as
their configuration files state them (the published block, with the
departures each file lists), in float32 PyTorch.  It imports nothing of
the program and takes from the run only the inputs the benchmark drew
(weights, tokens, patch embeddings) and, to judge them, the tokens the
program served.

A layer: ``x + attn(rms(x))``, then ``+ ffn(rms(.))``, where ``rms(x) = x
/ sqrt(mean(x^2) + eps) * (1 + gamma)``.  Attention: grouped-query heads
(query head ``h`` reads key head ``h // (H / Kv)``), rotate-half RoPE on q
and k at ``theta^(-i / (D/2))``, scores ``q.k / sqrt(D)``, soft-capped as
``cap * tanh(s / cap)`` where the configuration caps them, causal.  The
FFN: ``act(x Wg) * (x Wu) Wd`` with ``act`` SiLU (``swiglu``) or tanh-GELU
(``geglu``); an MoE FFN routes each token by ``softmax(x R)`` (float32) to
its ``k`` most probable experts (ties to the lower index), weights them
by their probabilities renormalised over the ``k``, and its experts are
SiLU-gated.  Then ``rms`` and the logits ``x U`` over the padded
vocabulary.  A VLM row's patch embeddings precede its token embeddings.

Attention runs in blocks of query rows, the FFN in blocks of tokens and an
expert at a time, each weight cast to float32 when its layer runs, so the
reference fits beside the served model.

**A routing choice near a tie.**  Where a token's ``k``-th and
``(k+1)``-th router logits lie within ``ROUTE_MARGIN`` of each other,
float32 cannot tell which expert the token belongs to any better than
the program's bfloat16 can, and the two choices give different outputs
(the experts differ; the choice is a step, not a slope).  At each compared
position the reference then follows every admissible choice (every set of
``k`` experts that holds those more than ``ROUTE_MARGIN`` above the
``k``-th logit and takes the rest from those within ``ROUTE_MARGIN`` of
it) through the remaining layers, against the keys and values of the
other positions, and returns each path's logits.  The judge takes the
path that fits the served token best.  Other positions' choices reach a
compared position only through one of its thousands of attended keys.

``ROUTE_MARGIN`` and ``MAX_PATHS`` were set from the rehearsal of the
grok-1 cells (PERF.md): at 0.05 decode positions whose router logits the
bf16 hidden state had flipped went unfollowed, at 0.3 the paths overran
16 a position; at 0.15 no position of 12 seeds reached 64.

``fp8=True`` is the control: every product's two operands rounded to
float8 e4m3 with one scale a tensor (the router's float32 product kept),
then multiplied in float32.  It follows its own routing alone: the judge
reads only its own path.

The module also states what the harness needs of an architecture: the
weights' ``layout``, a request's ``inputs`` and prefill ``positions``,
and the check's ``row`` of a served request.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
ATTN_BLOCK = 1024  # query rows a block of the attention
FFN_BLOCK = 8192  # tokens a block of a dense FFN or an expert
ROUTE_MARGIN = 0.15  # router logits this close to the k-th are followed both ways
MAX_PATHS = 64  # paths a compared position may follow
GAMMA_STD = 0.1  # a norm's gamma (the scale is 1 + gamma)


class Leaf(NamedTuple):
    """One weight: drawn N(0, std^2) in ``dtype``; where ``drawn_cols`` is
    set, the columns of its last axis from there on are zero."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float
    drawn_cols: Optional[int] = None


def _head_dim(config) -> int:
    return config.get("head_dim") or config["d_model"] // config["n_heads"]


def _is_moe_layer(config, i: int) -> bool:
    every = config.get("moe_every", 1)
    return config.get("n_experts", 0) > 0 and i % every == every - 1


def layout(config) -> List[Leaf]:
    """The weights as the published block has them and the port names its
    parameters (the JAX package's parameter tree, flattened):
    ``embed.embedding [V, d]``, ``embed.unembed [d, V]``,
    ``final_norm.gamma [d]`` and, for layer ``i``, ``layers.{i}.norm1.gamma``,
    ``layers.{i}.mixer.wq [d, H, D]``, ``wk``, ``wv [d, Kv, D]``, ``wo [H, D,
    d]``, ``layers.{i}.norm2.gamma`` and the FFN: ``ffn.w_gate``, ``ffn.w_up
    [d, ff]``, ``ffn.w_down [ff, d]``, or an MoE layer's ``ffn.router [d, E]``
    (float32), ``ffn.w_gate``, ``ffn.w_up [E, d, ff]``, ``ffn.w_down [E, ff,
    d]``.  ``V`` is the vocabulary padded to ``vocab_pad_multiple`` rows, as
    the port's table is; the padding's output columns are zero, as a served
    checkpoint's are, so no padding id is ever the best logit.  A product's
    weight is drawn N(0, 1/fan_in), a norm's gamma N(0, GAMMA_STD^2)."""
    d, H, Kv, D = config["d_model"], config["n_heads"], config["n_kv_heads"], _head_dim(config)
    m = config["vocab_pad_multiple"]
    ff, V, E = config["d_ff"], -(-config["vocab_size"] // m) * m, config.get("n_experts", 0)
    dt, f32 = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]], torch.float32

    def w(name, shape, fan_in, drawn_cols=None):
        return Leaf(name, shape, dt, 1.0 / math.sqrt(fan_in), drawn_cols)

    def norm(name):
        return Leaf(name, (d,), f32, GAMMA_STD)

    leaves = [w("embed.embedding", (V, d), d), w("embed.unembed", (d, V), d, config["vocab_size"]),
              norm("final_norm.gamma")]
    for i in range(config["n_layers"]):
        p = f"layers.{i}."
        leaves += [norm(p + "norm1.gamma"), w(p + "mixer.wq", (d, H, D), d), w(p + "mixer.wk", (d, Kv, D), d),
                   w(p + "mixer.wv", (d, Kv, D), d), w(p + "mixer.wo", (H, D, d), H * D), norm(p + "norm2.gamma")]
        if _is_moe_layer(config, i):
            leaves += [Leaf(p + "ffn.router", (d, E), f32, 1.0 / math.sqrt(d)),
                       w(p + "ffn.w_gate", (E, d, ff), d), w(p + "ffn.w_up", (E, d, ff), d),
                       w(p + "ffn.w_down", (E, ff, d), ff)]
        else:
            leaves += [w(p + "ffn.w_gate", (d, ff), d), w(p + "ffn.w_up", (d, ff), d),
                       w(p + "ffn.w_down", (ff, d), ff)]
    return leaves


def positions(config, length: int) -> int:
    """A request's prefill positions for ``length`` text tokens: a VLM's
    ``prefix_tokens`` patch positions come first."""
    return length + (int(config.get("prefix_tokens", 0)) if config.get("arch_type") == "vlm" else 0)


def inputs(config, mix, rows: int, length: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A request-batch's ``tokens [rows, length]`` (int64, uniform over the
    vocabulary) and, for a VLM, its ``prefix [rows, P, d]`` of patch
    embeddings, N(0, 1)·``mix["prefix_std"]`` in float32 as
    ``repro_torch.launch.serve.front_end_inputs`` draws them; all from
    ``gen`` on ``device``."""
    out = {"tokens": torch.randint(0, config["vocab_size"], (rows, length), generator=gen, device=device)}
    P = positions(config, 0)
    if P:
        out["prefix"] = torch.randn((rows, P, config["d_model"]), generator=gen, device=device) * float(
            mix["prefix_std"])
    return out


class Row(NamedTuple):
    tokens: torch.Tensor  # [L] int64
    prefix: Optional[torch.Tensor]  # [P, d] float32 patch embeddings, or None
    compare: torch.Tensor  # [n] positions (in the P + L sequence) whose logits are read


def row(inputs: Dict[str, torch.Tensor], r: int, served: List[int], prefill_positions: int) -> Row:
    """Row ``r`` of a request-batch's ``inputs`` with the tokens ``served``
    for it (the prefill's, then each decode step's) but the last fed back,
    compared at the last prefill position and at every decode position."""
    prompt = inputs["tokens"][r]
    fed = torch.tensor(served[:-1], dtype=prompt.dtype, device=prompt.device)
    prefix = inputs["prefix"][r] if "prefix" in inputs else None
    first = prefill_positions - 1
    return Row(torch.cat([prompt, fed]), prefix, torch.arange(first, first + len(served), device=prompt.device))


class Result(NamedTuple):
    logits: torch.Tensor  # [n, V]: the reference's own path at each compared position
    alternatives: List[Tuple[int, torch.Tensor]]  # (compared index, logits [V]) of other admissible paths
    margins: torch.Tensor  # [n]: the least k-th minus (k+1)-th router logit over the MoE layers (inf: none)


def _q(t: torch.Tensor, fp8: bool) -> torch.Tensor:
    if not fp8:
        return t
    scale = FP8_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    return _q(a, fp8) @ _q(b, fp8)


def _rms(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + gamma.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, h, D] at positions pos [S]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[:, None] * inv[None]
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if kind == "swiglu" else F.gelu(x, approximate="tanh")


class _Layer:
    """One layer's weights, each cast to float32 once."""

    def __init__(self, config, W: Dict[str, torch.Tensor], i: int):
        p = f"layers.{i}."
        d = config["d_model"]
        self.g1, self.g2 = W[p + "norm1.gamma"].float(), W[p + "norm2.gamma"].float()
        self.wq = W[p + "mixer.wq"].float().reshape(d, -1)
        self.wk = W[p + "mixer.wk"].float().reshape(d, -1)
        self.wv = W[p + "mixer.wv"].float().reshape(d, -1)
        self.wo = W[p + "mixer.wo"].float().reshape(-1, d)
        self.moe = (p + "ffn.router") in W
        self.W, self.p = W, p
        if self.moe:
            self.router = W[p + "ffn.router"].float()
        else:
            self.wg, self.wu, self.wd = (W[p + "ffn." + n].float() for n in ("w_gate", "w_up", "w_down"))


class _Branch(NamedTuple):
    row: int
    index: int  # compared index within the row
    pos: int
    x: torch.Tensor  # [d]


def _attend(q, k, v, q_pos, cap: Optional[float], fp8: bool) -> torch.Tensor:
    """Causal grouped-query attention of q [S, H, D] at positions q_pos [S]
    over k, v [T, Kv, D] at positions 0..T-1."""
    S, H, D = q.shape
    Kv = k.shape[1]
    g = H // Kv
    kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)  # [Kv, T, D]
    out = torch.empty_like(q)
    for a in range(0, S, ATTN_BLOCK):
        n = min(ATTN_BLOCK, S - a)
        pos = q_pos[a:a + n]
        end = int(pos.max()) + 1
        qg = q[a:a + n].reshape(n, Kv, g, D).permute(1, 2, 0, 3)  # [Kv, g, n, D]
        s = _mm(qg, kt[:, None, :end].transpose(-1, -2), fp8) / math.sqrt(D)  # [Kv, g, n, end]
        if cap:
            s = cap * torch.tanh(s / cap)
        s = s.masked_fill(torch.arange(end, device=q.device)[None] > pos[:, None], float("-inf"))
        o = _mm(torch.softmax(s, dim=-1), vt[:, None, :end], fp8)  # [Kv, g, n, D]
        out[a:a + n] = o.permute(2, 0, 1, 3).reshape(n, H, D)
    return out


def _ffn_dense(config, L: _Layer, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    out = torch.empty_like(x)
    for a in range(0, x.shape[0], FFN_BLOCK):
        xb = x[a:a + FFN_BLOCK]
        h = _act(config["mlp_type"], _mm(xb, L.wg, fp8)) * _mm(xb, L.wu, fp8)
        out[a:a + FFN_BLOCK] = _mm(h, L.wd, fp8)
    return out


def _top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[N, E] -> [N, k] experts, most probable first, the lower index first on ties."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]


def admissible(logits: torch.Tensor, k: int, margin: float) -> List[Tuple[int, ...]]:
    """The sets of ``k`` experts a token's router ``logits [E]`` admit within
    ``margin`` of the ``k``-th logit: the reference's own first."""
    own = tuple(int(e) for e in _top_k(logits[None], k)[0])
    kth = float(logits[own[-1]])
    vals = [float(v) for v in logits]
    sure = [e for e, v in enumerate(vals) if v > kth + margin]
    border = [e for e, v in enumerate(vals) if abs(v - kth) <= margin]
    sets = [own]
    for c in itertools.combinations(border, k - len(sure)):
        s = tuple(sure) + c
        if set(s) != set(own):
            sets.append(s)
    return sets


def _ffn_moe(config, L: _Layer, x: torch.Tensor, ids: torch.Tensor, fp8: bool) -> torch.Tensor:
    """The experts ``ids [N, k]`` of each token of ``x [N, d]`` (its norm), gated."""
    probs = torch.softmax(x @ L.router, dim=-1)
    gates = torch.gather(probs, 1, ids)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    tok = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(ids).reshape(-1)
    flat, gflat = ids.reshape(-1), gates.reshape(-1)
    for e in range(config["n_experts"]):
        sel = torch.nonzero(flat == e)[:, 0]
        if not len(sel):
            continue
        wg, wu, wd = (L.W[L.p + "ffn." + n][e].float() for n in ("w_gate", "w_up", "w_down"))
        for a in range(0, len(sel), FFN_BLOCK):
            s = sel[a:a + FFN_BLOCK]
            xb = x[tok[s]]
            h = F.silu(_mm(xb, wg, fp8)) * _mm(xb, wu, fp8)
            out.index_add_(0, tok[s], _mm(h, wd, fp8) * gflat[s, None])
        del wg, wu, wd
    return out


@torch.no_grad()
def forward(config, W: Dict[str, torch.Tensor], rows: List[Row], fp8: bool = False
            ) -> Tuple[List[Result], Dict[str, int]]:
    """The logits at each row's compared positions (float32, TF32 off), and
    counts of the paths followed (``branched``: compared positions with
    more than one admissible path; ``paths``: extra paths in all;
    ``capped``: positions that reached ``MAX_PATHS``)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(config, W, rows, fp8, 0.0 if fp8 else ROUTE_MARGIN)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _forward(config, W, rows, fp8, margin):
    d, H, Kv = config["d_model"], config["n_heads"], config["n_kv_heads"]
    D = _head_dim(config)
    eps, theta, cap = config["norm_eps"], config["rope_theta"], config.get("logit_softcap")
    k = config.get("experts_per_token", 0)
    dev = W["embed.embedding"].device
    xs = []
    for r in rows:
        x = W["embed.embedding"][r.tokens].float()
        if r.prefix is not None:
            x = torch.cat([r.prefix.float(), x], dim=0)
        xs.append(x)
    cmp_lists = [[int(p) for p in r.compare] for r in rows]
    branches: List[_Branch] = []
    margins = [torch.full((len(c),), float("inf"), device=dev) for c in cmp_lists]
    paths = {(ri, i): 1 for ri, c in enumerate(cmp_lists) for i in range(len(c))}
    stats = {"branched": 0, "paths": 0, "capped": 0}
    for li in range(config["n_layers"]):
        L = _Layer(config, W, li)
        kv = []
        for ri, x in enumerate(xs):
            S = x.shape[0]
            h = _rms(x, L.g1, eps)
            pos = torch.arange(S, device=dev)
            q = _rope(_mm(h, L.wq, fp8).view(S, H, D), pos, theta)
            kk = _rope(_mm(h, L.wk, fp8).view(S, Kv, D), pos, theta)
            vv = _mm(h, L.wv, fp8).view(S, Kv, D)
            xs[ri] = x + _mm(_attend(q, kk, vv, pos, cap, fp8).reshape(S, H * D), L.wo, fp8)
            kv.append((kk, vv) if L.moe or branches else None)
        for bi, b in enumerate(branches):  # one query at b.pos, its own key beside the others'
            h = _rms(b.x[None], L.g1, eps)
            pos = torch.tensor([b.pos], device=dev)
            q = _rope((h @ L.wq).view(1, H, D), pos, theta)
            kk = torch.cat([kv[b.row][0][:b.pos], _rope((h @ L.wk).view(1, Kv, D), pos, theta)])
            vv = torch.cat([kv[b.row][1][:b.pos], (h @ L.wv).view(1, Kv, D)])
            o = _attend(q, kk, vv, pos, cap, False).reshape(1, H * D) @ L.wo
            branches[bi] = b._replace(x=b.x + o[0])
        del kv
        sizes = [x.shape[0] for x in xs]
        xm = torch.cat(xs + [b.x[None] for b in branches]) if branches else torch.cat(xs)
        xn = _rms(xm, L.g2, eps)
        if not L.moe:
            xm = xm + _ffn_dense(config, L, xn, fp8)
        else:
            logits = xn @ L.router
            ids = _top_k(logits, k)
            new: List[Tuple[_Branch, Tuple[int, ...]]] = []
            srt = torch.sort(logits, dim=-1, descending=True)[0]
            gap = srt[:, k - 1] - srt[:, k]
            starts = [0] + list(itertools.accumulate(sizes))
            for ri, c in enumerate(cmp_lists):
                idx = torch.tensor(c, device=dev, dtype=torch.long) + starts[ri]
                margins[ri] = torch.minimum(margins[ri], gap[idx])
            if margin > 0:
                near = gap <= margin
                cands = [(starts[ri] + p, _Branch(ri, i, p, xm[starts[ri] + p]))
                         for ri, c in enumerate(cmp_lists) for i, p in enumerate(c)]
                cands += [(starts[-1] + bi, b) for bi, b in enumerate(branches)]
                for t, b in cands:
                    if not bool(near[t]):
                        continue
                    for s in admissible(logits[t], k, margin)[1:]:
                        if paths[(b.row, b.index)] >= MAX_PATHS:
                            stats["capped"] += 1
                            break
                        paths[(b.row, b.index)] += 1
                        new.append((b._replace(x=xm[t].clone()), s))
            if new:
                xn = torch.cat([xn, _rms(torch.stack([b.x for b, _ in new]), L.g2, eps)])
                ids = torch.cat([ids, torch.tensor([s for _, s in new], device=dev)])
                xm = torch.cat([xm, torch.stack([b.x for b, _ in new])])
            xm = xm + _ffn_moe(config, L, xn, ids, fp8)
            branches = branches + [b for b, _ in new]
        del L
        n_main = sum(sizes)
        xs = list(torch.split(xm[:n_main], sizes))
        branches = [b._replace(x=xm[n_main + bi]) for bi, b in enumerate(branches)]
    U = W["embed.unembed"].float()
    g = W["final_norm.gamma"]
    results = []
    for ri, (x, c) in enumerate(zip(xs, cmp_lists)):
        alts = [(b.index, _mm(_rms(b.x[None], g, eps), U, fp8)[0]) for b in branches if b.row == ri]
        results.append(Result(_mm(_rms(x[c], g, eps), U, fp8), alts, margins[ri]))
    stats["paths"] = len(branches)
    stats["branched"] = len({(b.row, b.index) for b in branches})
    return results, stats
