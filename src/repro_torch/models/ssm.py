"""Recurrent blocks: Mamba-2 (SSD, chunked), xLSTM's mLSTM and sLSTM.

Counterpart of ``src/repro/models/ssm.py``. The recurrences are plain
torch on every device (the reference's are plain ``jnp``: no Pallas
kernel); every projection goes through :func:`common.dense`, so in
quantized residency each is one ``dequant_matmul`` launch.

* Mamba-2 prefills in its chunked SSD form: inside a chunk of
  ``cfg.ssm_chunk`` tokens a masked decay product, between chunks the
  carried state (a Python loop over chunks where the reference scans).
  Decode is the single-step recurrence, with a causal conv cache of the
  last ``conv_width - 1`` pre-conv inputs.
* mLSTM and sLSTM run their step recurrence token by token, prefill and
  decode alike.

States are float32, as in the reference; the conv cache takes the
activation dtype. The float operations follow the reference's order
where it decides the sums (the conv's taps in tap order, ``cumsum``
then differences, the same contractions), so float32 outputs agree with
it to rounding. ``rows`` is the dense layers' (``common.dense_rows``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, dense, dense_init


def _const(v: torch.Tensor, lead: tuple, device) -> torch.Tensor:
    """A float32 vector stacked over ``lead``, a tensor of its own."""
    return v.to(device).expand(lead + tuple(v.shape)).clone()


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm (eps 1e-6) of ``y * silu(z)`` on a float32 copy with the
    float32 scale, rounded once to y's dtype."""
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    out = gf * torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + 1e-6) * scale
    return out.to(y.dtype)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ArchConfig):
    """(d_inner, heads, head dim, state size)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads if cfg.ssm_heads else max(1, d_inner // 64)
    return d_inner, H, d_inner // H, cfg.ssm_state


def mamba2_init(cfg: ArchConfig, generator: torch.Generator, lead: tuple = (), *,
                device="cuda") -> dict:
    """``in_proj`` fuses the [z, x, B, C, dt] projections."""
    d_inner, H, hd, N = mamba2_dims(cfg)
    return {
        "in_proj": dense_init(generator, cfg.d_model, 2 * d_inner + 2 * N + H, lead,
                              device=device),
        "conv_w": 0.1 * torch.randn(lead + (cfg.conv_width, d_inner), generator=generator,
                                    device=device),
        "conv_b": torch.zeros(lead + (d_inner,), device=device),
        "A_log": _const(torch.log(torch.linspace(1.0, 16.0, H)), lead, device),
        "D": torch.ones(lead + (H,), device=device),
        "dt_bias": _const(torch.log(torch.expm1(torch.full((H,), 0.01))), lead, device),
        "out_norm": torch.ones(lead + (d_inner,), device=device),
        "out_proj": dense_init(generator, d_inner, cfg.d_model, lead, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, the taps summed in order. x: (B, T, C); w:
    (W, C)."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def _split_proj(cfg: ArchConfig, p, u: torch.Tensor, rows: str):
    d_inner, H, hd, N = mamba2_dims(cfg)
    zxbcdt = dense(u, p["in_proj"], dtype=u.dtype, rows=rows)
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def _mamba2_scan(cfg: ArchConfig, p, u: torch.Tensor, state=None, rows: str = "any"):
    """The chunked SSD scan. Returns (out, final state, pre-conv x)."""
    d_inner, H, hd, N = mamba2_dims(cfg)
    B_, T, _ = u.shape
    dtype = u.dtype
    z, x_pre, Bm, Cm, dt_raw = _split_proj(cfg, p, u, rows)
    x = F.silu(_causal_conv(x_pre, p["conv_w"].to(dtype), p["conv_b"].to(dtype)))
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])        # (B, T, H)
    a_log = -dt * torch.exp(p["A_log"])                               # log decay

    L = min(cfg.ssm_chunk, T)
    pad = (-T) % L
    if pad:
        # padded steps decay by exp(0) = 1 and add nothing (dt = 0)
        x, Bm, Cm, dt, a_log = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm, dt, a_log))
    nC = (T + pad) // L
    xh = x.reshape(B_, nC, L, H, hd)
    Bc = Bm.reshape(B_, nC, L, N).to(torch.float32)
    Cc = Cm.reshape(B_, nC, L, N).to(torch.float32)
    dtc = dt.reshape(B_, nC, L, H)
    alc = a_log.reshape(B_, nC, L, H)
    ii = torch.arange(L, device=u.device)
    mask = (ii[:, None] >= ii[None, :])[None, :, :, None]

    S = (torch.zeros((B_, H, N, hd), dtype=torch.float32, device=u.device)
         if state is None else state.to(torch.float32))
    ys = []
    for c in range(nC):
        xk, Bk, Ck = xh[:, c].to(torch.float32), Bc[:, c], Cc[:, c]
        dtk, alk = dtc[:, c], alc[:, c]
        cum = torch.cumsum(alk, dim=1)                                # (B, L, H) inclusive
        # intra-chunk: the masked decay product
        seg = cum[:, :, None, :] - cum[:, None, :, :]                 # (B, i, j, H)
        decay = torch.where(mask, torch.exp(seg), 0.0)
        CB = torch.einsum("bin,bjn->bij", Ck, Bk)
        Wd = CB[..., None] * decay * dtk[:, None, :, :]
        y = torch.einsum("bijh,bjhd->bihd", Wd, xk)
        # inter-chunk: the incoming state's contribution
        y = y + torch.einsum("bin,bih,bhnd->bihd", Ck, torch.exp(cum), S)
        rem = torch.exp(cum[:, -1:, :] - cum)                         # decay from j to the end
        S = torch.exp(cum[:, -1])[:, :, None, None] * S + torch.einsum(
            "bjh,bjn,bjhd->bhnd", dtk * rem, Bk, xk)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B_, nC * L, H, hd)[:, :T]
    y = y + x[:, :T].reshape(B_, T, H, hd).to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B_, T, d_inner).to(dtype)
    out = dense(_gated_norm(y, z, p["out_norm"]), p["out_proj"], dtype=dtype, rows=rows)
    return out, S, x_pre


def mamba2_forward(cfg: ArchConfig, p, u: torch.Tensor, state=None, return_state=False,
                   *, rows: str = "any"):
    """Chunked SSD scan. u: (B, T, d_model) -> (B, T, d_model)."""
    out, S, _ = _mamba2_scan(cfg, p, u, state, rows)
    return (out, S) if return_state else out


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype, lead: tuple = (), *,
                      device="cuda") -> dict:
    d_inner, H, hd, N = mamba2_dims(cfg)
    return {"state": torch.zeros(lead + (batch, H, N, hd), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, d_inner), dtype=dtype,
                                device=device)}


def mamba2_prefill(cfg: ArchConfig, p, u: torch.Tensor, *, rows: str = "any"):
    """The forward and its cache: the final state and the last
    ``conv_width - 1`` pre-conv inputs (zeros before the prompt). The
    reference projects ``u`` a second time for the conv cache; B2 is
    deterministic, so the forward's projection is the same values."""
    out, S, x = _mamba2_scan(cfg, p, u, rows=rows)
    Wc = cfg.conv_width
    conv = x[:, -(Wc - 1):, :]
    if conv.shape[1] < Wc - 1:
        conv = F.pad(conv, (0, 0, Wc - 1 - conv.shape[1], 0))
    return out, {"state": S, "conv": conv.contiguous()}


def mamba2_step(cfg: ArchConfig, p, u: torch.Tensor, cache, *, rows: str = "decode"):
    """Single-token decode. u: (B, 1, d_model). Returns (out, new cache);
    ``cache`` is read, not written."""
    d_inner, H, hd, N = mamba2_dims(cfg)
    dtype = u.dtype
    z, x, Bm, Cm, dt_raw = _split_proj(cfg, p, u, rows)                  # (B, 1, .)
    conv_in = torch.cat([cache["conv"], x], dim=1)                        # (B, W, d_inner)
    w = p["conv_w"].to(dtype)
    xc = F.silu((conv_in * w[None]).sum(dim=1, keepdim=True) + p["conv_b"].to(dtype))
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])     # (B, H)
    a = torch.exp(-dt * torch.exp(p["A_log"]))
    xh = xc[:, 0].reshape(-1, H, hd).to(torch.float32)
    Bv = Bm[:, 0].to(torch.float32)                                       # (B, N)
    Cv = Cm[:, 0].to(torch.float32)
    S = a[:, :, None, None] * cache["state"] + torch.einsum("bh,bn,bhd->bhnd", dt, Bv, xh)
    y = torch.einsum("bn,bhnd->bhd", Cv, S) + xh * p["D"][None, :, None]
    y = y.reshape(-1, 1, d_inner).to(dtype)
    out = dense(_gated_norm(y, z, p["out_norm"]), p["out_proj"], dtype=dtype, rows=rows)
    return out, {"state": S, "conv": conv_in[:, 1:, :]}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ArchConfig):
    """(d_inner, heads, head dim)."""
    d_inner = int(cfg.lstm_proj_factor * cfg.d_model)
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def mlstm_init(cfg: ArchConfig, generator: torch.Generator, lead: tuple = (), *,
               device="cuda") -> dict:
    d_inner, H, hd = mlstm_dims(cfg)

    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead, device=device)

    return {
        "up_proj": w(cfg.d_model, 2 * d_inner),
        "wq": w(d_inner, d_inner),
        "wk": w(d_inner, d_inner),
        "wv": w(d_inner, d_inner),
        "w_if": w(d_inner, 2 * H),
        "b_if": _const(torch.cat([torch.zeros(H), 3.0 * torch.ones(H)]), lead, device),
        "out_norm": torch.ones(lead + (d_inner,), device=device),
        "down_proj": w(d_inner, cfg.d_model),
    }


def _mlstm_qkvif(cfg: ArchConfig, p, u: torch.Tensor, rows: str):
    d_inner, H, hd = mlstm_dims(cfg)
    dt = u.dtype
    x_in, z = torch.chunk(dense(u, p["up_proj"], dtype=dt, rows=rows), 2, dim=-1)
    B_, T, _ = x_in.shape
    q = dense(x_in, p["wq"], dtype=dt, rows=rows).reshape(B_, T, H, hd)
    k = dense(x_in, p["wk"], dtype=dt, rows=rows).reshape(B_, T, H, hd) * (hd ** -0.5)
    v = dense(x_in, p["wv"], dtype=dt, rows=rows).reshape(B_, T, H, hd)
    i_f = dense(x_in, p["w_if"], dtype=dt, rows=rows).to(torch.float32) + p["b_if"]
    i_raw, f_raw = torch.chunk(i_f, 2, dim=-1)                            # (B, T, H)
    return z, q, k, v, i_raw, f_raw


def _mlstm_cell(carry, xs):
    """Stabilised mLSTM step. carry: (C, n, m)."""
    C, n, m = carry                        # (B, H, hd, hd), (B, H, hd), (B, H)
    q, k, v, i_raw, f_raw = xs             # (B, H, hd) x3, (B, H) x2
    f_log = -F.softplus(-f_raw)            # log sigmoid(f)
    m_new = torch.maximum(f_log + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_log + m - m_new)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)), torch.exp(-m_new))
    h = torch.einsum("bhvd,bhd->bhv", C_new, q) / denom[..., None]
    return (C_new, n_new, m_new), h


def mlstm_forward(cfg: ArchConfig, p, u: torch.Tensor, cache=None, return_cache=False, *,
                  rows: str = "any"):
    d_inner, H, hd = mlstm_dims(cfg)
    B_, T, _ = u.shape
    z, q, k, v, i_raw, f_raw = _mlstm_qkvif(cfg, p, u, rows)
    if cache is None:
        carry = tuple(mlstm_init_cache(cfg, B_, u.dtype, device=u.device).values())
    else:
        carry = (cache["C"], cache["n"], cache["m"])
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    hs = []
    for t in range(T):
        carry, h = _mlstm_cell(carry, (q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t]))
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B_, T, d_inner).to(u.dtype)
    out = dense(_gated_norm(h, z, p["out_norm"]), p["down_proj"], dtype=u.dtype, rows=rows)
    if return_cache:
        C, n, m = carry
        return out, {"C": C, "n": n, "m": m}
    return out


def mlstm_init_cache(cfg: ArchConfig, batch: int, dtype, lead: tuple = (), *,
                     device="cuda") -> dict:
    d_inner, H, hd = mlstm_dims(cfg)
    return {"C": torch.zeros(lead + (batch, H, hd, hd), device=device),
            "n": torch.zeros(lead + (batch, H, hd), device=device),
            "m": torch.zeros(lead + (batch, H), device=device)}


def mlstm_step(cfg: ArchConfig, p, u: torch.Tensor, cache, *, rows: str = "decode"):
    return mlstm_forward(cfg, p, u, cache=cache, return_cache=True, rows=rows)


# ---------------------------------------------------------------------------
# xLSTM: sLSTM (scalar memory, per-head recurrent mixing)
# ---------------------------------------------------------------------------

def slstm_dims(cfg: ArchConfig):
    """(d_inner, heads, head dim): the sLSTM runs at the model's width."""
    return cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads


def slstm_init(cfg: ArchConfig, generator: torch.Generator, lead: tuple = (), *,
               device="cuda") -> dict:
    d_inner, H, hd = slstm_dims(cfg)
    d_up = int(4 * d_inner / 3)
    return {
        "w_in": dense_init(generator, cfg.d_model, 4 * d_inner, lead, device=device),  # z i f o
        "r": 0.1 * torch.randn(lead + (H, hd, 4 * hd), generator=generator, device=device),
        "b": torch.zeros(lead + (4 * d_inner,), device=device),
        "out_norm": torch.ones(lead + (d_inner,), device=device),
        "up_proj": dense_init(generator, d_inner, d_up, lead, device=device),
        "down_proj": dense_init(generator, d_up, cfg.d_model, lead, device=device),
    }


def _slstm_cell(p_r: torch.Tensor, carry, x_t: torch.Tensor):
    """x_t: (B, 4 * d_inner) pre-activations from the input; the
    recurrent term comes from h through the block-diagonal per-head r."""
    c, n, h, m = carry                     # (B, d_inner) x3, (B, H)
    B_ = h.shape[0]
    H, hd, _ = p_r.shape
    rec = torch.einsum("bhd,hdf->bhf", h.reshape(B_, H, hd), p_r).reshape(B_, 4 * H * hd)
    z_r, i_r, f_r, o_r = torch.chunk(x_t + rec, 4, dim=-1)
    zh = torch.tanh(z_r)
    oh = torch.sigmoid(o_r)
    i_rh = i_r.reshape(B_, H, hd)
    f_log = -F.softplus(-f_r.reshape(B_, H, hd))
    m_new = torch.maximum(f_log.amax(dim=-1) + m, i_rh.amax(dim=-1))   # per-head stabiliser
    i_g = torch.exp(i_rh - m_new[..., None]).reshape(B_, -1)
    f_g = torch.exp(f_log + (m - m_new)[..., None]).reshape(B_, -1)
    c_new = f_g * c + i_g * zh
    n_new = f_g * n + i_g
    h_new = oh * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_forward(cfg: ArchConfig, p, u: torch.Tensor, cache=None, return_cache=False, *,
                  rows: str = "any"):
    d_inner, H, hd = slstm_dims(cfg)
    B_, T, _ = u.shape
    dt = u.dtype
    x_pre = dense(u, p["w_in"], dtype=dt, rows=rows).to(torch.float32) + p["b"]
    if cache is None:
        carry = tuple(slstm_init_cache(cfg, B_, dt, device=u.device).values())
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    hs = []
    for t in range(T):
        carry, h = _slstm_cell(p["r"], carry, x_pre[:, t])
        hs.append(h)
    yf = torch.stack(hs, dim=1).to(dt).to(torch.float32)                 # (B, T, d_inner)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
         * p["out_norm"]).to(dt)
    up = F.gelu(dense(y, p["up_proj"], dtype=dt, rows=rows), approximate="tanh")
    out = dense(up, p["down_proj"], dtype=dt, rows=rows)
    if return_cache:
        c, n, h, m = carry
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def slstm_init_cache(cfg: ArchConfig, batch: int, dtype, lead: tuple = (), *,
                     device="cuda") -> dict:
    """c, n and h are tensors of their own (a decode step writes each in
    place)."""
    d_inner, H, hd = slstm_dims(cfg)
    return {"c": torch.zeros(lead + (batch, d_inner), device=device),
            "n": torch.zeros(lead + (batch, d_inner), device=device),
            "h": torch.zeros(lead + (batch, d_inner), device=device),
            "m": torch.zeros(lead + (batch, H), device=device)}


def slstm_step(cfg: ArchConfig, p, u: torch.Tensor, cache, *, rows: str = "decode"):
    return slstm_forward(cfg, p, u, cache=cache, return_cache=True, rows=rows)


RECURRENT_KINDS = ("mamba2", "mlstm", "slstm")
FORWARD = {"mamba2": mamba2_forward, "mlstm": mlstm_forward, "slstm": slstm_forward}
STEP = {"mamba2": mamba2_step, "mlstm": mlstm_step, "slstm": slstm_step}
INIT = {"mamba2": mamba2_init, "mlstm": mlstm_init, "slstm": slstm_init}
INIT_CACHE = {"mamba2": mamba2_init_cache, "mlstm": mlstm_init_cache,
              "slstm": slstm_init_cache}


def prefill(cfg: ArchConfig, kind: str, p, u: torch.Tensor, *, rows: str = "any"):
    """A recurrent block's prompt pass and its cache."""
    if kind == "mamba2":
        return mamba2_prefill(cfg, p, u, rows=rows)
    fwd = mlstm_forward if kind == "mlstm" else slstm_forward
    return fwd(cfg, p, u, return_cache=True, rows=rows)
