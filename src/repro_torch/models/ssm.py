"""State-space and recurrent mixers: Mamba (jamba), mLSTM and sLSTM
(xlstm).  The port's counterpart of ``repro/models/ssm.py``, function for
function.

All three keep **constant-size state** (``MambaState``, ``MLSTMState``,
``SLSTMState``, float32 but for Mamba's trailing convolution inputs, which
keep the activation type), which is what lets their architectures decode
at any context length.  The JAX package has no Pallas kernel here (its
scans are ``lax.scan`` and ``lax.associative_scan``), and neither has the
port: these are plain PyTorch, on the card as on the CPU.

* **Mamba**: the causal depthwise convolution, then the selective scan
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` over chunks of
  ``min(128, S)`` steps.  Inside a chunk the JAX package runs
  ``lax.associative_scan`` with the combine ``(A1·A2, b1·A2 + b2)``; torch
  has no counterpart, so every chunk is scanned at once by doubling
  (Hillis-Steele: log2(128) = 7 steps of elementwise work on ``[B, n_chunks,
  chunk, d_inner, d_state]``), then each chunk's start state is carried
  across the chunks in order, as the JAX ``lax.scan`` carries ``h[-1]``.
  The doubling multiplies in another order than XLA's tree, so Mamba
  agrees with the JAX package to a tolerance, not to the bit.
* **mLSTM**: chunkwise-parallel linear attention with exponential input
  and sigmoid forget gates, an intra-chunk quadratic term (its decay
  matrix masked with ``-inf`` before the ``exp``, so the backward sees no
  ``inf · 0``) and the inter-chunk matrix memory ``C [B, H, D, D]`` carried
  in a loop over the chunks.  Its head dimension is ``d_inner // n_heads``
  (``cfg.head_dim`` is ignored, as in the JAX package).
* **sLSTM**: sequential (the paper says so): a Python loop over the
  sequence, one step a token, its per-head recurrence one batched matmul,
  then the block's gated FFN (tanh-approximated gelu).  At a long prompt it
  is host-bound: about 20 operations a token and layer.

The chunk rule: a sequence of S > 128 tokens must be a multiple of 128
(``chunk_len``); the JAX package asserts it.  Nothing pads, because padding
would change the final state that decode starts from.

The parameters are named as the JAX dict keys, with their dtypes (``w_if``,
``r_h``, ``A_log``, ``D``, ``dt_bias``, ``b_if`` and ``b`` float32; the
rest the activation type), so ``convert`` carries them by name and
``model.param_tree`` sorts them into the JAX leaf order.  Each mixer's
projections, Mamba's scan, the mLSTM's chunk loop and the sLSTM's step
loop run in spans (``obs/trace.py``: ``ssm.projections``, ``ssm.mamba_scan``,
``ssm.mlstm_chunks``, ``ssm.slstm_steps``), profiler ranges while one records.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _zeros, make_param, pdtype
from repro_torch.obs import trace

CHUNK = 128  # the scans' chunk length (the JAX package's min(128, S))


def chunk_len(S: int) -> int:
    """``min(CHUNK, S)``; raises ``ValueError`` where it does not divide
    S (the chunk rule)."""
    chunk = min(CHUNK, S)
    if S < 1 or S % chunk:
        raise ValueError(f"the chunk rule: a recurrent layer scans a sequence in chunks of min({CHUNK}, S) "
                         f"tokens, so S must be at most {CHUNK} or a multiple of {CHUNK}; got S = {S}")
    return chunk


def check_chunk_rule(cfg: ArchConfig, S: int) -> None:
    """Raises the chunk rule's ``ValueError`` where ``cfg`` has a recurrent
    layer and a sequence of S tokens breaks the rule (the entry points ask
    before they build a model)."""
    if any(desc.mixer in ("mamba", "mlstm", "slstm") for desc in cfg.pattern()[0]):
        chunk_len(S)


def _param(value: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(value, requires_grad=False)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, d_conv - 1, d_inner] — trailing inputs
    ssm: torch.Tensor  # [B, d_inner, d_state] float32


def _mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank, cfg.d_state


class Mamba(nn.Module):
    """``in_proj [d, 2 di]``, ``conv_w [d_conv, di]``, ``x_proj [di, dtr +
    2 ds]``, ``dt_proj [dtr, di]``, ``dt_bias [di]``, ``A_log [di, ds]``
    (log 1..ds), ``D [di]`` (ones), ``out_proj [di, d]``."""

    AXES = {"in_proj": ("embed", "dinner"), "conv_w": (None, "dinner"), "x_proj": ("dinner", None),
            "dt_proj": (None, "dinner"), "dt_bias": ("dinner",), "A_log": ("dinner", None),
            "D": ("dinner",), "out_proj": ("dinner", "embed")}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        di, dtr, ds = _mamba_dims(cfg)
        dt, dev = pdtype(cfg), gen.device
        self.in_proj = make_param(gen, (d, 2 * di), dt)
        self.conv_w = make_param(gen, (cfg.d_conv, di), dt, fan_in=cfg.d_conv)
        self.x_proj = make_param(gen, (di, dtr + 2 * ds), dt, fan_in=di)
        self.dt_proj = make_param(gen, (dtr, di), dt, fan_in=dtr)
        self.dt_bias = _zeros((di,), dev)
        a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
        self.A_log = _param(torch.log(a)[None, :].expand(di, ds).clone())
        self.D = _param(torch.ones((di,), dtype=torch.float32, device=dev))
        self.out_proj = make_param(gen, (di, d), dt, fan_in=di)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along ``dim`` from
    ``h = 0``, by doubling: after the step of offset k, element t holds the
    composition of elements ``t-2k+1 .. t``, combined as ``(A1·A2, b1·A2 +
    b2)`` with the earlier segment first.  Returns (the products of ``a``,
    the states from 0)."""
    L, k = a.shape[dim], 1
    while k < L:
        a_lo, a_hi = a.narrow(dim, 0, L - k), a.narrow(dim, k, L - k)
        b_lo, b_hi = b.narrow(dim, 0, L - k), b.narrow(dim, k, L - k)
        b = torch.cat([b.narrow(dim, 0, k), b_lo * a_hi + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, k), a_lo * a_hi], dim)
        k *= 2
    return a, b


def _mamba_inner(cfg: ArchConfig, p: Mamba, xz: torch.Tensor, conv_init: torch.Tensor,
                 ssm_init: torch.Tensor) -> Tuple[torch.Tensor, MambaState]:
    """xz: [B, S, 2·di] -> (y [B, S, di], final ``MambaState``)."""
    di, dtr, ds = _mamba_dims(cfg)
    x, z = xz.chunk(2, dim=-1)  # [B, S, di]
    B_, S, _ = x.shape
    chunk = chunk_len(S)
    n_chunks = S // chunk

    with trace.span("ssm.mamba_scan"):
        # causal depthwise conv over time (kernel d_conv), float32
        xpad = torch.cat([conv_init.to(x.dtype), x], dim=1)  # [B, S + dc - 1, di]
        conv_tail = xpad[:, S:, :]  # the new trailing state (the last dc - 1 inputs)
        w = p.conv_w.float()
        xc = xpad[:, 0:S].float() * w[0]
        for i in range(1, cfg.d_conv):
            xc = xc + xpad[:, i:i + S].float() * w[i]
        xc = F.silu(xc)  # [B, S, di] f32

        proj = xc.to(x.dtype) @ p.x_proj  # [B, S, dtr + 2 ds]
        dt_in, Bc, Cc = proj.float().split([dtr, ds, ds], dim=-1)
        dt = F.softplus(dt_in @ p.dt_proj.float() + p.dt_bias)  # [B, S, di]
        A = -torch.exp(p.A_log)  # [di, ds]

        # discretise: h_t = exp(dt A) h_{t-1} + dt * B_t * x_t ; y = C_t . h + D x
        dA = torch.exp(dt[..., None] * A)  # [B, S, di, ds]
        dBx = dt[..., None] * Bc[:, :, None, :] * xc[..., None]  # [B, S, di, ds]
        shape = (B_, n_chunks, chunk, di, ds)
        Acum, hpart = _doubling_scan(dA.reshape(shape), dBx.reshape(shape), dim=2)
        # each chunk starts from the previous chunk's last state
        starts, h = [], ssm_init.float()
        for c in range(n_chunks):
            starts.append(h)
            h = hpart[:, c, -1] + Acum[:, c, -1] * h
        hs = (hpart + Acum * torch.stack(starts, dim=1)[:, :, None]).reshape(B_, S, di, ds)

        y = torch.einsum("bsdn,bsn->bsd", hs, Cc) + p.D * xc
        y = y * F.silu(z.float())
    return y.to(xz.dtype), MambaState(conv_tail, h)


def apply_mamba(cfg: ArchConfig, p: Mamba, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward. x: [B, S, d]."""
    return mamba_prefill(cfg, p, x)[0]


def mamba_prefill(cfg: ArchConfig, p: Mamba, x: torch.Tensor) -> Tuple[torch.Tensor, MambaState]:
    state = init_mamba_state(cfg, x.shape[0], x.dtype, x.device)
    with trace.span("ssm.projections"):
        xz = x @ p.in_proj
    y, state = _mamba_inner(cfg, p, xz, state.conv, state.ssm)
    with trace.span("ssm.projections"):
        return y @ p.out_proj, state


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device) -> MambaState:
    di, _, ds = _mamba_dims(cfg)
    return MambaState(
        torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype, device=device),
        torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
    )


def mamba_decode(cfg: ArchConfig, p: Mamba, x: torch.Tensor, state: MambaState):
    """One token. x: [B, 1, d]."""
    with trace.span("ssm.projections"):
        xz = x @ p.in_proj
    y, new_state = _mamba_inner(cfg, p, xz, state.conv, state.ssm)
    with trace.span("ssm.projections"):
        return y @ p.out_proj, new_state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block, chunkwise-parallel)
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    C: torch.Tensor  # [B, H, D, D] matrix memory, float32
    n: torch.Tensor  # [B, H, D] normaliser, float32


def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    di = cfg.ssm_expand * cfg.d_model  # up-projection factor 2 (xLSTM pf=2)
    return di, di // cfg.n_heads  # (d_inner, head_dim)


class MLSTM(nn.Module):
    """``up_proj [d, 2 di]`` (x_inner, z gate), ``wq``/``wk``/``wv [di, H,
    Dh]`` (full projections, as in the JAX package), ``w_if [di, 2, H]``
    and ``b_if [2, H]`` (input and forget gates, float32), ``down_proj
    [di, d]``."""

    AXES = {"up_proj": ("embed", "dinner"), "wq": ("dinner", "heads", "head_dim"),
            "wk": ("dinner", "heads", "head_dim"), "wv": ("dinner", "heads", "head_dim"),
            "w_if": ("dinner", None, "heads"), "b_if": (None, "heads"), "down_proj": ("dinner", "embed")}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        di, Dh = _mlstm_dims(cfg)
        dt = pdtype(cfg)
        self.up_proj = make_param(gen, (d, 2 * di), dt)
        self.wq = make_param(gen, (di, H, Dh), dt, fan_in=di)
        self.wk = make_param(gen, (di, H, Dh), dt, fan_in=di)
        self.wv = make_param(gen, (di, H, Dh), dt, fan_in=di)
        self.w_if = make_param(gen, (di, 2, H), torch.float32, fan_in=di)
        self.b_if = _zeros((2, H), gen.device)
        self.down_proj = make_param(gen, (di, d), dt, fan_in=di)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, di] @ [di, *tail] -> [B, S, *tail], one matmul."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _mlstm_gates(p: MLSTM, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log-f (sigmoid in log space) and log-i (clipped exp gate)."""
    gf = _heads(xi.float(), p.w_if) + p.b_if  # [B, S, 2, H]
    log_i = torch.clamp(gf[:, :, 0, :], -8.0, 8.0)  # [B, S, H]
    log_f = F.logsigmoid(gf[:, :, 1, :])  # [B, S, H] (<= 0)
    return log_i, log_f


def _mlstm_chunk(cfg: ArchConfig, q, k, v, log_i, log_f, C0, n0):
    """One chunk, parallel form.  q/k/v: [B, L, H, D]; gates [B, L, H]."""
    B, L, H, D = q.shape
    F_ = torch.cumsum(log_f, dim=1)  # [B, L, H] inclusive
    scale = float(1.0 / torch.tensor(float(D)).sqrt())  # in float32, as the JAX package's
    qf, kf, vf = q.float(), k.float(), v.float()

    # intra-chunk: D[t,s] = exp(F_t - F_s) * i_s  for s <= t
    dmat = F_[:, :, None, :] - F_[:, None, :, :] + log_i[:, None, :, :]  # [B, T, S, H]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~causal[None, :, :, None], -math.inf)  # masked before the exp
    w = torch.exp(dmat)  # decay-gated weights
    logits = torch.einsum("bthd,bshd->btsh", qf, kf) * scale
    intra = torch.einsum("btsh,bshd->bthd", logits * w, vf)
    intra_n = torch.einsum("btsh,bshd->bthd", w, kf)  # normaliser numerator

    # inter-chunk: h_t += exp(F_t) q_t C0 ; n_t += exp(F_t) q_t . n0
    decay_t = torch.exp(F_)  # [B, L, H]
    inter = torch.einsum("bthd,bhde->bthe", qf * scale, C0) * decay_t[..., None]
    inter_n = n0[:, None] * decay_t[..., None]  # [B, L, H, D]

    h_num = intra + inter
    n_vec = intra_n + inter_n
    denom = torch.clamp_min(torch.abs(torch.sum(qf * scale * n_vec, dim=-1)), 1.0)  # [B, L, H]
    h = h_num / denom[..., None]

    # chunk-final state: C_L = exp(F_L) C0 + sum_s exp(F_L - F_s) i_s k_s v_s^T
    wL = torch.exp(F_[:, -1:, :] - F_ + log_i)  # [B, L, H]
    # the gate weighs k before the product: a three-operand einsum could
    # build the [B, L, H, D, D] outer product first
    C_new = (torch.exp(F_[:, -1])[:, :, None, None] * C0
             + torch.einsum("bshd,bshe->bhde", kf * wL[..., None], vf))
    n_new = torch.exp(F_[:, -1])[:, :, None] * n0 + torch.einsum("bshd,bsh->bhd", kf, wL)
    return h, C_new, n_new


def apply_mlstm(cfg: ArchConfig, p: MLSTM, x: torch.Tensor,
                state: Optional[MLSTMState] = None) -> Tuple[torch.Tensor, MLSTMState]:
    """x: [B, S, d] -> ([B, S, d], final state)."""
    B, S, _ = x.shape
    di, Dh = _mlstm_dims(cfg)
    chunk = chunk_len(S)
    with trace.span("ssm.projections"):
        up = x @ p.up_proj
        xi, z = up.chunk(2, dim=-1)  # [B, S, di]
        q, k, v = _heads(xi, p.wq), _heads(xi, p.wk), _heads(xi, p.wv)
        log_i, log_f = _mlstm_gates(p, xi)

    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    C, n = state
    with trace.span("ssm.mlstm_chunks"):
        hs = []
        for lo in range(0, S, chunk):
            sl = slice(lo, lo + chunk)
            h, C, n = _mlstm_chunk(cfg, q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl], C, n)
            hs.append(h)
        h = torch.cat(hs, dim=1).reshape(B, S, di)
    with trace.span("ssm.projections"):
        out = (h.to(x.dtype) * F.silu(z)) @ p.down_proj
    return out, MLSTMState(C, n)


def init_mlstm_state(cfg: ArchConfig, batch: int, device) -> MLSTMState:
    _, Dh = _mlstm_dims(cfg)
    return MLSTMState(
        torch.zeros((batch, cfg.n_heads, Dh, Dh), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.n_heads, Dh), dtype=torch.float32, device=device),
    )


def mlstm_decode(cfg: ArchConfig, p: MLSTM, x: torch.Tensor, state: MLSTMState):
    return apply_mlstm(cfg, p, x, state)  # S == 1: one chunk


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory block with exponential gating; sequential scan)
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    h: torch.Tensor  # [B, H, D]
    c: torch.Tensor  # [B, H, D]
    n: torch.Tensor  # [B, H, D]
    m: torch.Tensor  # [B, H, D] gate stabiliser


def _slstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    H = cfg.n_heads
    return H, cfg.d_model // H


class SLSTM(nn.Module):
    """``w_x [d, 4, H, Dh]`` (the gates i, f, z, o from the input), ``r_h
    [4, H, Dh, Dh]`` (from each head's h, float32), ``b [4, H, Dh]``
    (float32), and the post-block gated FFN ``w_ff_up [d, 2 ffd]``,
    ``w_ff_down [ffd, d]`` (ffd = 4/3 d, the xLSTM paper's)."""

    AXES = {"w_x": ("embed", None, "heads", "head_dim"), "r_h": (None, "heads", "head_dim", None),
            "b": (None, "heads", "head_dim"), "w_ff_up": ("embed", "ff"), "w_ff_down": ("ff", "embed")}

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        H, Dh = _slstm_dims(cfg)
        dt = pdtype(cfg)
        ffd = max(1, int(cfg.d_model * 4 / 3))
        self.w_x = make_param(gen, (d, 4, H, Dh), dt, fan_in=d)
        self.r_h = make_param(gen, (4, H, Dh, Dh), torch.float32, fan_in=Dh)
        self.b = _zeros((4, H, Dh), gen.device)
        self.w_ff_up = make_param(gen, (d, 2 * ffd), dt)
        self.w_ff_down = make_param(gen, (ffd, d), dt, fan_in=ffd)


def _slstm_step(r: torch.Tensor, b: torch.Tensor, carry: SLSTMState, gx: torch.Tensor):
    """gx: [B, 4, H, D] float32, the input's contribution to the gates; r:
    ``r_h`` as ``[H, D, 4·D]`` (:func:`apply_slstm`), so each head's
    recurrence is one batched matmul."""
    h, c, n, m = carry
    B, H, D = h.shape
    rec = torch.bmm(h.transpose(0, 1), r).view(H, B, 4, D).permute(1, 2, 0, 3)  # [B, 4, H, D]
    g = gx + rec + b
    gi, gf, gz, go = g.unbind(1)
    # stabilised exponential gating (xLSTM eq. 15-17)
    log_f = F.logsigmoid(gf)
    lf_m = log_f + m
    m_new = torch.maximum(lf_m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(lf_m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp_min(torch.abs(n_new), 1.0)
    return SLSTMState(h_new, c_new, n_new, m_new)


def apply_slstm(cfg: ArchConfig, p: SLSTM, x: torch.Tensor,
                state: Optional[SLSTMState] = None) -> Tuple[torch.Tensor, SLSTMState]:
    """x: [B, S, d] -> ([B, S, d], final state). Sequential over S."""
    B, S, d = x.shape
    H, Dh = _slstm_dims(cfg)
    with trace.span("ssm.projections"):
        gx = _heads(x, p.w_x).float()  # [B, S, 4, H, Dh]
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    with trace.span("ssm.slstm_steps"):
        r = p.r_h.permute(1, 2, 0, 3).reshape(H, Dh, 4 * Dh)
        hs = []
        for t in range(S):
            state = _slstm_step(r, p.b, state, gx[:, t])
            hs.append(state.h)
        y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    with trace.span("ssm.projections"):
        # gated FFN
        u, g = (y @ p.w_ff_up).chunk(2, dim=-1)
        y = (u * F.gelu(g, approximate="tanh")) @ p.w_ff_down
    return y, state


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> SLSTMState:
    H, Dh = _slstm_dims(cfg)
    z = torch.zeros((batch, H, Dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z.clone(), z.clone(), z - 30.0)


def slstm_decode(cfg: ArchConfig, p: SLSTM, x: torch.Tensor, state: SLSTMState):
    return apply_slstm(cfg, p, x, state)
