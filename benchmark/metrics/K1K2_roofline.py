"""K1 and K2, the fused attention and MLP sites of the engine's encoder,
prior blocks and decoder (`layernorm_kernel`, `gemm_sm90`,
`site_attention_sm90`, `finish_kernel`), against the sum of every site's
bound at 989 TFLOP/s bf16. K1's and K2's GEMM launches share kernel
instances (the residual epilogue), so their times cannot be told apart by
name: the two are one family here."""
from benchmark.counts.work import roofline_share

UNIT = "%"
NAMES = {"layernorm_kernel", "gemm_sm90", "site_attention_sm90", "finish_kernel"}


def read(run, suffix):
    return roofline_share(run, NAMES, "k1k2_bound_s")
