"""A dense decoder of the stablelm family in plain PyTorch, float32 with
TF32 off, and the weights both sides are given.

The forward pass follows the published StableLM-3B-4E1T description
(pre-LayerNorm with bias, rotary attention, a SiLU-gated MLP, an untied
head) and, where the port departs from it, the port's choice, which the
configuration file names under ``departures``: the rotary rotates every
dimension of a head (split in halves), not the first quarter.  It uses
none of the program's code: no kernel, no cache, no batching.

``make_weights`` builds the weights the harness hands to the program and
to this reference alike, on the device and from the seed, in the type
they are served in (bfloat16 matrices, float32 norms), from one
generator in two large draws.  The reference widens them to float32 a
layer at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Params = Dict


def _shapes(spec: dict):
    d, h, kh, hd, f, v = (spec["hidden_size"], spec["num_attention_heads"],
                          spec["num_key_value_heads"], spec["head_dim"],
                          spec["intermediate_size"], spec["vocab_size"])
    L = spec["num_hidden_layers"]
    down = 1.0 / math.sqrt(2 * L)
    layer = [("wq", (d, h * hd), 1 / math.sqrt(d)),
             ("wk", (d, kh * hd), 1 / math.sqrt(d)),
             ("wv", (d, kh * hd), 1 / math.sqrt(d)),
             ("wo", (h * hd, d), down / math.sqrt(h * hd)),
             ("wg", (d, f), 1 / math.sqrt(d)),
             ("wu", (d, f), 1 / math.sqrt(d)),
             ("wd", (f, d), down / math.sqrt(f))]
    return d, v, L, layer


def make_weights(spec: dict, seed: int, device) -> Params:
    """Random weights in the port's parameter layout: every matrix a view
    of one buffer of the served type, drawn in one call and scaled per
    matrix; the norms (scale about 1, bias about 0) of one float32
    buffer."""
    d, v, L, layer = _shapes(spec)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    n_layer = sum(a * b for _, (a, b), _ in layer)
    flat = torch.empty(2 * v * d + L * n_layer,
                       dtype=getattr(torch, spec["torch_dtype"]),
                       device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    norms = torch.empty((2 * L + 1) * 2 * d, dtype=torch.float32,
                        device=device)
    norms.normal_(0.0, 0.1, generator=gen)
    at = [0]

    def take(shape, std):
        n = shape[0] * shape[1]
        w = flat[at[0]:at[0] + n].view(shape)
        at[0] += n
        return w.mul_(std)

    nat = [0]

    def norm():
        s = norms[nat[0]:nat[0] + d]
        b = norms[nat[0] + d:nat[0] + 2 * d]
        nat[0] += 2 * d
        return {"scale": s.add_(1.0), "bias": b}

    params = {"embed": {"table": take((v, d), 0.02),
                        "head": take((d, v), 1 / math.sqrt(d))},
              "layers": [], "norm_f": None}
    for _ in range(L):
        ws = {name: take(shape, std) for name, shape, std in layer}
        params["layers"].append({
            "attn": {k: ws[k] for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: ws[k] for k in ("wg", "wu", "wd")},
            "norm1": norm(), "norm2": norm()})
    params["norm_f"] = norm()
    return params


# --------------------------------------------------------------------- #
# The forward pass                                                      #
# --------------------------------------------------------------------- #

def _layernorm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()


def _rotary(x, theta):
    """x (S, H, D) rotated by position: dimension i of the first half
    pairs with dimension i of the second, at frequency theta^(-2i/D)."""
    S, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v, block):
    """Causal attention of q (S, H, D) over k, v (S, KH, D), a block of
    queries at a time."""
    S, H, D = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s0 in range(0, S, block):
        qb = q[s0:s0 + block].transpose(0, 1)                  # (H, n, D)
        n = qb.shape[1]
        s = qb @ k[:, :s0 + n].transpose(1, 2) / math.sqrt(D)
        pos = torch.arange(s0, s0 + n, device=q.device)
        mask = torch.arange(s0 + n, device=q.device)[None, :] > pos[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out[s0:s0 + n] = (torch.softmax(s, -1) @ v[:, :s0 + n]
                          ).transpose(0, 1)
    return out


def plain_mm(x, w):
    return x @ w.float()


def logits(spec: dict, params: Params, tokens: torch.Tensor,
           rows: torch.Tensor, mm: Callable = plain_mm,
           block: int = 512) -> torch.Tensor:
    """float32 logits (len(rows), V) at positions ``rows`` of the
    sequence ``tokens`` (S,), every position attending causally to the
    ones before it.  ``mm(x, w)`` is the matrix product with a weight
    (the control's lower precision replaces it)."""
    H, KH, D = (spec["num_attention_heads"], spec["num_key_value_heads"],
                spec["head_dim"])
    eps, theta = spec["layer_norm_eps"], spec["rope_theta"]
    S = tokens.shape[0]
    x = params["embed"]["table"][tokens.long()].float()
    for p in params["layers"]:
        h = _layernorm(x, p["norm1"], eps)
        a = p["attn"]
        q = _rotary(mm(h, a["wq"]).view(S, H, D), theta)
        k = _rotary(mm(h, a["wk"]).view(S, KH, D), theta)
        v = mm(h, a["wv"]).view(S, KH, D)
        x = x + mm(_attention(q, k, v, block).reshape(S, H * D), a["wo"])
        h = _layernorm(x, p["norm2"], eps)
        m = p["mlp"]
        x = x + mm(torch.nn.functional.silu(mm(h, m["wg"])) * mm(h, m["wu"]),
                   m["wd"])
    x = _layernorm(x[rows], params["norm_f"], eps)
    return mm(x, params["embed"]["head"])


# --------------------------------------------------------------------- #
# The control: the same pass a precision below the served one           #
# --------------------------------------------------------------------- #

def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the largest magnitude maps to 448), widened back."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x, w):
    """Weights per output column and activations per token in float8
    e4m3, their product accumulated in float32."""
    return _fp8(x, -1) @ _fp8(w.float(), 0)


def precision_off_tf32() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def served_gaps(spec: dict, params: Params, prompt, plen: int, served,
                device, control: bool = False) -> torch.Tensor:
    """For one request: the prompt padded with id 0 to ``plen``, then
    every served token but the last, through the reference.  Returns, at
    each served position, how far the served token's reference logit
    lies below the reference's best (``control``: how far the token the
    float8 control puts first lies below it)."""
    n = len(served)
    seq = torch.zeros(plen + n - 1, dtype=torch.long)
    seq[:len(prompt)] = torch.as_tensor(prompt, dtype=torch.long)
    seq[plen:] = torch.as_tensor(served[:-1], dtype=torch.long)
    seq = seq.to(device)
    rows = torch.arange(plen - 1, plen - 1 + n, device=device)
    with torch.no_grad():
        ref = logits(spec, params, seq, rows)
        if control:
            pick = logits(spec, params, seq, rows, mm=fp8_mm).argmax(-1)
        else:
            pick = torch.as_tensor(served, dtype=torch.long, device=device)
        best = ref.max(-1).values
        return (best - ref.gather(-1, pick[:, None])[:, 0]).cpu()
