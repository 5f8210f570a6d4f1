"""Frozen operation and byte counts of the port's kernels, and their least
time on one NVIDIA H100 SXM (the published dense peaks at its 700 W limit).

A kernel's bound is the larger of its operations over the peak of the
precision it computes in and its bytes over the memory bandwidth. Each
input byte is counted read once and each output byte written once. For the
3xTF32 kernels (K6 / K9 fp32, K7 / K8 fp32) the operations are counted
three times, at the TF32 peak.
"""
from __future__ import annotations

PEAK = {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12}
BANDWIDTH = 3.35e12
SIZE = {"bf16": 2, "fp32": 4}


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    return max(ops / PEAK[peak], nbytes / BANDWIDTH)


def attention_site(G, B, N, C, Nk=None):
    """K1: LayerNorm, q / k / v projections (RoPE), attention and the output
    projection with its residual, bf16, G streams of B rows of N tokens.
    Returns (ops, bytes)."""
    Nk = N if Nk is None else Nk
    ops = 2.0 * G * B * (2 * N + 2 * Nk) * C * C + 4.0 * G * B * N * Nk * C
    nbytes = 2.0 * G * (B * (2 * N + Nk) * C + 4 * C * C)
    return ops, nbytes


def mlp_site(G, B, N, C, F):
    """K2: LayerNorm, fc1 with GELU, fc2 with the residual, bf16."""
    return 4.0 * G * B * N * C * F, 2.0 * G * (2 * B * N * C + 2 * C * F)


def flash_fp32(B, H, N, D):
    """K9's fp32 forward (3xTF32): QK^T and PV."""
    return 3.0 * 4.0 * B * H * N * N * D, 4.0 * 4 * B * H * N * D


def edge_loss(e2, A, n, dtype, backward: bool):
    """K3 (forward) or K4 (backward) over 2E = e2 packed terms of A pixels:
    the packed points (3 channels) and weights in `dtype`, the n frames'
    fp32 projected points read, and K4's gradient of them written."""
    s = SIZE[dtype]
    nbytes = e2 * 3 * A * s + e2 * A * s + n * 3 * A * 4 + (n * 3 * A * 4 if backward else 0)
    return 0.0, float(nbytes)


def engine_sites(frames: int, pairs: int, batch: int, tokens: int, net: dict,
                 encode_chunk: int = 16):
    """Every K1 / K2 site the engine runs for one video, as (kind, ops,
    bytes): the encoder over frames in chunks of `encode_chunk`, the prior
    blocks and both decoder streams over pairs in batches of `batch`."""
    De, Dd, r = net["enc_embed_dim"], net["dec_embed_dim"], net["mlp_ratio"]
    out = []
    for s in range(0, frames, encode_chunk):
        b = min(encode_chunk, frames - s)
        for _ in range(net["enc_depth"]):
            out.append(("K1",) + attention_site(1, b, tokens, De))
            out.append(("K2",) + mlp_site(1, b, tokens, De, int(De * r)))
    n_pc = net["dec_depth"] // 2 - 2
    for s in range(0, pairs, batch):
        b = min(batch, pairs - s)
        for layer in range(net["dec_depth"]):
            out.append(("K1",) + attention_site(2, b, tokens, Dd))
            out.append(("K1",) + attention_site(2, b, tokens, Dd))
            out.append(("K2",) + mlp_site(2, b, tokens, Dd, int(Dd * r)))
            if layer < n_pc:
                out.append(("K1",) + attention_site(1, 2 * b, tokens, Dd))
                out.append(("K2",) + mlp_site(1, 2 * b, tokens, Dd, int(Dd * r)))
    return out
