"""Declarative model configuration (+ parser for reference eval()-style
strings): the port's own copy of align3r_tpu/models/config.py, kept equal to
it by tests/test_torch_imports.py.

The reference stores its config as a Python constructor string inside the
checkpoint (dust3r/model.py:27-43) and eval()s it. We keep a declarative
dataclass as the source of truth and provide `parse_model_string` for
checkpoint compatibility (dust3r/training.py:129, train.sh:8).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Align3RConfig:
    # ViT-L/16 512 defaults == released Align3R checkpoints (train.sh:8)
    img_size: Tuple[int, int] = (512, 512)
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0          # pos_embed='RoPE100'
    pos_embed: str = "RoPE100"        # 'RoPE<base>' | 'cosine' (croco.py:36,52-68)
    norm_im2_in_dec: bool = True
    # heads
    head_type: str = "dpt"            # 'dpt' | 'linear'
    output_mode: str = "pts3d"
    depth_mode: Tuple[str, float, float] = ("exp", -INF, INF)
    conf_mode: Tuple[str, float, float] = ("exp", 1.0, INF)
    landscape_only: bool = True
    @property
    def effective_rope_base(self):
        """None disables RoPE (cosine tables are added to tokens instead)."""
        return None if self.pos_embed == "cosine" else self.rope_base

    # prior-injection branch: dec_depth//2 - 2 extra blocks (croco.py:78-80)
    @property
    def n_pc_blocks(self) -> int:
        return self.dec_depth // 2 - 2

    @property
    def n_zero_convs(self) -> int:
        return self.n_pc_blocks + 1

    @property
    def head_dim(self) -> int:
        return self.enc_embed_dim // self.enc_num_heads

    def dpt_hooks(self):
        l2 = self.dec_depth
        return [0, l2 * 2 // 4, l2 * 3 // 4, l2]

    def dpt_dim_tokens(self):
        return [self.enc_embed_dim, self.dec_embed_dim, self.dec_embed_dim, self.dec_embed_dim]


VIT_L_512 = Align3RConfig()

TINY_TEST = Align3RConfig(
    img_size=(64, 64), enc_embed_dim=64, enc_depth=4, enc_num_heads=4,
    dec_embed_dim=48, dec_depth=12, dec_num_heads=4)


def parse_model_string(s: str) -> Align3RConfig:
    """Parse a reference `AsymmetricCroCo3DStereo(...)` constructor string.

    The string is evaluated with the constructor replaced by a
    kwargs-capturing stub (the reference itself eval()s it against the real
    class, dust3r/model.py:39); only literals/tuples/`inf` are in scope.
    A regex cannot do this: tuple values like `img_size=(512, 288)` or
    `depth_mode=('exp', -inf, inf)` contain commas (a latent bug the
    golden-parity self-check caught — the old regex silently mangled both).
    """
    m = re.match(r"\s*(\w+)\s*\(", s)
    if not m:
        raise ValueError(f"not a constructor string: {s[:80]!r}")
    captured = {}

    def ctor(*args, **kw):
        if args:
            raise ValueError(f"unexpected positional args in model string: {args}")
        captured.update(kw)

    eval(s, {"__builtins__": {}, m.group(1): ctor, "inf": INF}, {})

    img_size = captured.get("img_size", (512, 512))
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    pos_embed = str(captured.get("pos_embed", "RoPE100"))
    rope_base = (float(pos_embed[len("RoPE"):])
                 if pos_embed.startswith("RoPE") else 100.0)
    return Align3RConfig(
        img_size=tuple(img_size),
        patch_size=captured.get("patch_size", 16),
        enc_embed_dim=captured.get("enc_embed_dim", 1024),
        enc_depth=captured.get("enc_depth", 24),
        enc_num_heads=captured.get("enc_num_heads", 16),
        dec_embed_dim=captured.get("dec_embed_dim", 768),
        dec_depth=captured.get("dec_depth", 12),
        dec_num_heads=captured.get("dec_num_heads", 12),
        mlp_ratio=captured.get("mlp_ratio", 4.0),
        rope_base=rope_base,
        pos_embed=pos_embed,
        head_type=captured.get("head_type", "dpt"),
        output_mode=captured.get("output_mode", "pts3d"),
        depth_mode=tuple(captured.get("depth_mode", ("exp", -INF, INF))),
        conf_mode=tuple(captured.get("conf_mode", ("exp", 1.0, INF))),
        landscape_only=bool(captured.get("landscape_only", True)),
    )


def model_string(cfg: Align3RConfig) -> str:
    """The reference constructor string of a config, the `args.model` a
    reference checkpoint carries; `parse_model_string` reads it back."""
    return ("AsymmetricCroCo3DStereo("
            f"pos_embed={cfg.pos_embed!r}, img_size={tuple(cfg.img_size)!r}, "
            f"head_type={cfg.head_type!r}, output_mode={cfg.output_mode!r}, "
            f"depth_mode={tuple(cfg.depth_mode)!r}, conf_mode={tuple(cfg.conf_mode)!r}, "
            f"enc_embed_dim={cfg.enc_embed_dim}, enc_depth={cfg.enc_depth}, "
            f"enc_num_heads={cfg.enc_num_heads}, dec_embed_dim={cfg.dec_embed_dim}, "
            f"dec_depth={cfg.dec_depth}, dec_num_heads={cfg.dec_num_heads}, "
            f"mlp_ratio={cfg.mlp_ratio!r}, patch_size={cfg.patch_size}, "
            f"landscape_only={cfg.landscape_only!r})")
