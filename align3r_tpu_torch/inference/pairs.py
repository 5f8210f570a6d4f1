"""Frame-graph construction (pairs of image indices): the port's own copy of
align3r_tpu/inference/pairs.py, held to it by tests/test_torch_imports.py.

Behavioural reference: the reference dust3r/image_pairs.py:11-111. We work
with integer indices instead of image dicts (the engine owns the tensors);
`make_pairs` accepts either an int (number of frames) or a list. Pair sets
are emitted in sorted order for determinism (the reference iterates a Python
set; edge order is semantically irrelevant downstream).

Graph types:
  complete            all (i, j), i > j
  swin-k[-noncyclic]  sliding window, stride 1, window k
  swinstride-k        stride 2
  swin2stride-k       stride 3
  logwin-k            offsets 2^0..2^(k-1) both directions
  oneref-i            star graph centred on frame i
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

Edge = Tuple[int, int]


def make_pairs(imgs, scene_graph: str = "complete", prefilter=None,
               symmetrize: bool = True) -> List[Edge]:
    n = imgs if isinstance(imgs, int) else len(imgs)
    pairs: List[Edge] = []
    if scene_graph == "complete":
        for i in range(n):
            for j in range(i):
                pairs.append((i, j))
    elif scene_graph.startswith("swin"):
        iscyclic = not scene_graph.endswith("noncyclic")
        try:
            winsize = int(scene_graph.split("-")[1])
        except (IndexError, ValueError):
            winsize = 3
        if scene_graph.startswith("swinstride"):
            stride = 2
        elif scene_graph.startswith("swin2stride"):
            stride = 3
        else:
            stride = 1
        pairsid = set()
        for i in range(n):
            for off in range(1, stride * winsize + 1, stride):
                idx = i + off
                if iscyclic:
                    idx = idx % n
                if idx >= n:
                    continue
                pairsid.add((i, idx) if i < idx else (idx, i))
        pairs = sorted(pairsid)
    elif scene_graph.startswith("logwin"):
        iscyclic = not scene_graph.endswith("noncyclic")
        try:
            winsize = int(scene_graph.split("-")[1])
        except (IndexError, ValueError):
            winsize = 3
        offsets = [2 ** k for k in range(winsize)]
        pairsid = set()
        for i in range(n):
            for j in [i - o for o in offsets] + [i + o for o in offsets]:
                if iscyclic:
                    j = j % n
                if j < 0 or j >= n or j == i:
                    continue
                pairsid.add((i, j) if i < j else (j, i))
        pairs = sorted(pairsid)
    elif scene_graph.startswith("oneref"):
        refid = int(scene_graph.split("-")[1]) if "-" in scene_graph else 0
        pairs = [(refid, j) for j in range(n) if j != refid]
    else:
        raise ValueError(f"unknown scene_graph {scene_graph!r}")

    if symmetrize:
        pairs = pairs + [(j, i) for i, j in pairs]

    if isinstance(prefilter, str) and prefilter.startswith("seq"):
        pairs = filter_pairs_seq(pairs, int(prefilter[3:]))
    elif isinstance(prefilter, str) and prefilter.startswith("cyc"):
        pairs = filter_pairs_seq(pairs, int(prefilter[3:]), cyclic=True)
    return pairs


def filter_pairs_seq(pairs: Sequence[Edge], seq_dis_thr: int, cyclic: bool = False):
    n = max(max(e) for e in pairs) + 1
    kept = []
    for (i, j) in pairs:
        dis = abs(i - j)
        if cyclic:
            dis = min(dis, abs(i + n - j), abs(i - n - j))
        if dis <= seq_dis_thr:
            kept.append((i, j))
    return kept


def hierarchical_pairs(n: int, clip_size: int = 10) -> Tuple[List[int], List[Edge], List[List[int]]]:
    """Keyframe graph + per-clip frame groups for the hierarchical pipeline
    (reference tool/demo.py:357-397 my_make_pairs).

    Returns (keyframe indices, complete keyframe edges, per-clip frame lists;
    each clip spans [k·clip_size, (k+1)·clip_size] inclusive of the next
    keyframe so consecutive clips share an anchor frame).
    """
    keyframes = list(range(0, n, clip_size))
    key_edges = [(a, b) for ia, a in enumerate(keyframes) for b in keyframes[:ia]]
    clips = []
    for s in range(0, n, clip_size):
        clip = list(range(s, min(s + clip_size + 1, n)))
        if len(clip) > 1:
            clips.append(clip)
    return keyframes, key_edges, clips


def is_symmetrized(edges: Sequence[Edge]) -> bool:
    """True when every (i, j) has its reversed twin (reference
    dust3r/utils/misc.py:32-40 instance-pattern check, index-based here)."""
    s = set(map(tuple, edges))
    return all((j, i) in s for i, j in s)


def filter_output_edges_seq(output: dict, seq_dis_thr: int, cyclic: bool = False):
    """Drop long-range edges from an inference output dict (reference
    image_pairs.py:105-111 filter_edges_seq). Every array or tensor whose
    leading dim is the edge count is indexed; everything else is kept."""
    import numpy as np
    import torch
    idx_i = np.asarray(output["view1"]["idx"])
    idx_j = np.asarray(output["view2"]["idx"])
    n = int(max(idx_i.max(), idx_j.max())) + 1
    dis = np.abs(idx_i - idx_j)
    if cyclic:
        dis = np.minimum(dis, np.minimum(np.abs(idx_i + n - idx_j),
                                         np.abs(idx_i - n - idx_j)))
    kept = np.nonzero(dis <= seq_dis_thr)[0]

    def sel(x):
        if isinstance(x, dict):
            return {k: sel(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.shape[:1] == idx_i.shape:
            return x[torch.from_numpy(kept).to(x.device)]
        if isinstance(x, np.ndarray) and x.shape[:1] == idx_i.shape:
            return x[kept]
        return x

    return {k: sel(v) for k, v in output.items()}
