"""Save, or compare bit for bit, the GEMM core's outputs at N % 128 == 0.

    python align3r_tpu_torch/tools/gemm_bits.py TREE OUT [REF]

Imports ``align3r_tpu_torch`` from TREE (this checkout, or a parent's
``git archive`` unpacked under ``build/``), runs K1/K2's GEMM launch
(``ops.fused_site.gemm``) with every bf16 epilogue at the main path's and a
few ragged shapes, and K7's bf16 unit (``ops.dpt_pipeline.fused_res_unit``,
the same core as a convolution), all from seeded inputs, and saves the
outputs to OUT. With REF (another tree's OUT) it prints whether every output
has the same bits and exits 1 if one differs. Run it as a file, not with
``-m``: the package must come from TREE. Needs a card.
"""
import os
import sys

SHAPES = [(2, 135, 128, 128), (1, 9216, 1024, 1024), (2, 18432, 768, 768),
          (1, 9216, 1024, 4096), (2, 18432, 3072, 768), (3, 129, 384, 128), (1, 1, 128, 64)]
UNITS = [(2, 9, 16, 256), (32, 72, 128, 256)]


def outputs(dev):
    import torch
    from align3r_tpu_torch.ops import dpt_pipeline as dp
    from align3r_tpu_torch.ops import fused_site as fs
    res = {}
    for shape in SHAPES:
        G, M, N, K = shape
        g = torch.Generator(device=dev).manual_seed(7)
        rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device=dev) * sc
        a = rnd(G, M, K).to(torch.bfloat16)
        w = rnd(G, K, N, sc=K ** -0.5).to(torch.bfloat16)
        b, r = rnd(G, N, sc=0.1), rnd(G, M, N).to(torch.bfloat16)
        ang = rnd(576, 64, sc=3.0)
        cos, sin = torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)
        for e in (fs.EPI_BIAS, fs.EPI_ROPE, fs.EPI_GELU, fs.EPI_RESID):
            res[(shape, e)] = fs.gemm(a, w, b, e, resid=r if e == fs.EPI_RESID else None,
                                      cos=cos if e == fs.EPI_ROPE else None,
                                      sin=sin if e == fs.EPI_ROPE else None,
                                      rope_d=64, rope_n=576).cpu()
    for shape in UNITS:
        g = torch.Generator(device=dev).manual_seed(11)
        v, base = (torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(2))
        C = shape[-1]

        def conv():
            return (torch.randn(C, C, 3, 3, generator=g, device=dev) / (3 * C ** 0.5),
                    0.1 * torch.randn(C, generator=g, device=dev))

        res[(shape, "res_unit")] = dp.fused_res_unit(v, (conv(), conv()), base).cpu()
    torch.cuda.synchronize()
    return res


def main(argv) -> int:
    tree, out = argv[0], argv[1]
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from align3r_tpu_torch.ops import fused_site
    if not fused_site.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"align3r_tpu_torch came from {fused_site.__file__}, not {tree}")
    res = outputs(torch.device("cuda", 0))
    torch.save(res, out)
    if len(argv) > 2:
        ref = torch.load(argv[2])
        bad = [k for k in ref if not torch.equal(ref[k], res[k])]
        print("GEMM_BITS", "same bits" if not bad else f"DIFFER {bad}", len(ref), "outputs",
              flush=True)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
