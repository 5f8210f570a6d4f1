"""Plain float32 reference of the Align3R two-view network (arXiv:2412.03079):
a CroCo ViT encoder with RoPE2D, the prior point cloud patch-embedded and
run through its own blocks, injected into both decoder streams through
zero-initialised 1x1 convolutions, a dual-stream decoder whose streams
cross-attend to each other, and a DPT head per view with the exp depth and
confidence activations.

Parameter names are the reference checkpoint's (dust3r/model.py,
croco/models/croco.py), so the benchmark's state dict loads into this
module and into the program's. Each product runs through `common` under a
`Precision`: part "trunk" for the encoder, prior blocks and decoder, part
"heads" for the DPT heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import common as C


class _Mlp(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, h), nn.Linear(h, d)


class _Attn(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)


class _Cross(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.projq, self.projk = nn.Linear(d, d), nn.Linear(d, d)
        self.projv, self.proj = nn.Linear(d, d), nn.Linear(d, d)


class Block(nn.Module):
    def __init__(self, d, ratio):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)
        self.attn, self.mlp = _Attn(d), _Mlp(d, int(d * ratio))


class DecoderBlock(nn.Module):
    def __init__(self, d, ratio):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)
        self.norm3, self.norm_y = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)
        self.attn, self.cross_attn = _Attn(d), _Cross(d)
        self.mlp = _Mlp(d, int(d * ratio))


class _PatchEmbed(nn.Module):
    def __init__(self, p, d):
        super().__init__()
        self.proj = nn.Conv2d(3, d, p, stride=p)


class _Unit(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)


class _Fusion(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.resConfUnit1, self.resConfUnit2 = _Unit(c), _Unit(c)
        self.out_conv = nn.Conv2d(c, c, 1)


class _Scratch(nn.Module):
    def __init__(self, dims, f):
        super().__init__()
        for k, d in enumerate(dims, 1):
            setattr(self, f"layer{k}_rn", nn.Conv2d(d, f, 3, padding=1, bias=False))
        self.layer_rn = nn.ModuleList([getattr(self, f"layer{k}_rn")
                                       for k in range(1, len(dims) + 1)])
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", _Fusion(f))


class _Adapter(nn.Module):
    def __init__(self, dim_tokens, nch, dims=(96, 192, 384, 768), f=256):
        super().__init__()
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dim_tokens[0], dims[0], 1),
                          nn.ConvTranspose2d(dims[0], dims[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(dim_tokens[1], dims[1], 1),
                          nn.ConvTranspose2d(dims[1], dims[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(dim_tokens[2], dims[2], 1)),
            nn.Sequential(nn.Conv2d(dim_tokens[3], dims[3], 1),
                          nn.Conv2d(dims[3], dims[3], 3, stride=2, padding=1))])
        self.scratch = _Scratch(dims, f)
        self.head = nn.Sequential(nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
                                  nn.Conv2d(f // 2, f // 2, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(f // 2, nch, 1))


class _Head(nn.Module):
    def __init__(self, dim_tokens, nch):
        super().__init__()
        self.dpt = _Adapter(dim_tokens, nch)


class Align3R(nn.Module):
    """net: the configuration file's "network" group."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        De, Dd, r = net["enc_embed_dim"], net["dec_embed_dim"], net["mlp_ratio"]
        n_pc = net["dec_depth"] // 2 - 2
        self.patch_embed = _PatchEmbed(net["patch_size"], De)
        self.patch_embed_point_cloud = _PatchEmbed(net["patch_size"], Dd)
        self.enc_blocks = nn.ModuleList(Block(De, r) for _ in range(net["enc_depth"]))
        self.enc_norm = nn.LayerNorm(De, eps=1e-6)
        self.decoder_embed = nn.Linear(De, Dd)
        self.dec_blocks = nn.ModuleList(DecoderBlock(Dd, r) for _ in range(net["dec_depth"]))
        self.dec_blocks2 = nn.ModuleList(DecoderBlock(Dd, r) for _ in range(net["dec_depth"]))
        self.dec_blocks_pc = nn.ModuleList(Block(Dd, r) for _ in range(n_pc))
        self.dec_norm = nn.LayerNorm(Dd, eps=1e-6)
        self.zero_convs = nn.ModuleList(nn.Sequential(nn.Conv1d(Dd, Dd, 1))
                                        for _ in range(n_pc + 1))
        dims = [De, Dd, Dd, Dd]
        self.downstream_head1, self.downstream_head2 = _Head(dims, 4), _Head(dims, 4)

    # ------------------------------------------------------------ trunk
    def _rope(self, t, pos):
        """RoPE2D (base from pos_embed 'RoPE<base>'): the first half of the
        head dim rotated by y, the second by x, frequencies base^(-2i/(D/2))
        duplicated, rotate_half (-x2, x1) within each half."""
        base = float(self.net["pos_embed"][len("RoPE"):])
        D = t.shape[-1]
        half = D // 2
        inv = 1.0 / (base ** (torch.arange(0, half, 2, dtype=torch.float32, device=t.device) / half))

        def cs(p):
            f = p.float()[:, None] * inv
            f = torch.cat([f, f], -1)
            return torch.cos(f), torch.sin(f)

        cy, sy = cs(pos[:, 0])
        cx, sx = cs(pos[:, 1])
        cos, sin = torch.cat([cy, cx], -1), torch.cat([sy, sx], -1)
        q = D // 4
        t5 = t.reshape(*t.shape[:-1], 2, 2, q)
        rot = torch.cat([-t5[..., 1:2, :], t5[..., 0:1, :]], dim=-2).reshape(t.shape)
        return t * cos + rot * sin

    def _mha(self, P, xq, xkv, wq, bq, wk, bk, wv, bv, wo, bo, heads, pos):
        B, N, Cx = xq.shape
        split = lambda t: t.reshape(B, -1, heads, Cx // heads).transpose(1, 2)
        q = split(C.linear(P, "trunk", xq, wq, bq))
        k = split(C.linear(P, "trunk", xkv, wk, bk))
        v = split(C.linear(P, "trunk", xkv, wv, bv))
        out = C.attention(P, "trunk", self._rope(q, pos), self._rope(k, pos), v)
        return C.linear(P, "trunk", out.transpose(1, 2).reshape(B, N, Cx), wo, bo)

    def _mlp(self, P, m, x):
        return C.linear(P, "trunk", C.gelu(C.linear(P, "trunk", x, m.fc1.weight, m.fc1.bias)),
                        m.fc2.weight, m.fc2.bias)

    def _self_attn(self, P, b, x, heads, pos):
        Cx = x.shape[-1]
        w, bb = b.attn.qkv.weight, b.attn.qkv.bias
        h = C.layernorm(x, b.norm1.weight, b.norm1.bias)
        return x + self._mha(P, h, h, w[:Cx], bb[:Cx], w[Cx:2 * Cx], bb[Cx:2 * Cx], w[2 * Cx:],
                             bb[2 * Cx:], b.attn.proj.weight, b.attn.proj.bias, heads, pos)

    def _block(self, P, b, x, heads, pos):
        x = self._self_attn(P, b, x, heads, pos)
        return x + self._mlp(P, b.mlp, C.layernorm(x, b.norm2.weight, b.norm2.bias))

    def _dec_block(self, P, b, x, y, heads, pos):
        """Self-attention, cross-attention to the other stream's input y
        (normalised by norm_y), MLP."""
        x = self._self_attn(P, b, x, heads, pos)
        ca = b.cross_attn
        yn = C.layernorm(y, b.norm_y.weight, b.norm_y.bias)
        x = x + self._mha(P, C.layernorm(x, b.norm2.weight, b.norm2.bias), yn,
                          ca.projq.weight, ca.projq.bias, ca.projk.weight, ca.projk.bias,
                          ca.projv.weight, ca.projv.bias, ca.proj.weight, ca.proj.bias,
                          heads, pos)
        return x + self._mlp(P, b.mlp, C.layernorm(x, b.norm3.weight, b.norm3.bias))

    def _embed(self, P, pe, img):
        """(B, H, W, 3) -> (B, h w, D) tokens."""
        t = C.conv2d(P, "trunk", img.permute(0, 3, 1, 2), pe.proj.weight, pe.proj.bias,
                     stride=pe.proj.stride[0])
        return t.flatten(2).transpose(1, 2)

    def encode(self, P, imgs):
        """imgs (B, H, W, 3) in [-1, 1] -> encoder tokens (B, N, De)."""
        p = self.net["patch_size"]
        pos = _grid(imgs.shape[1] // p, imgs.shape[2] // p, imgs.device)
        x = self._embed(P, self.patch_embed, imgs)
        for b in self.enc_blocks:
            x = self._block(P, b, x, self.net["enc_num_heads"], pos)
        return C.layernorm(x, self.enc_norm.weight, self.enc_norm.bias)

    def pairs(self, P, feats, priors, ii, jj, hw):
        """Both views' outputs for pairs (ii[k], jj[k]) of encoded frames
        `feats` (n, N, De) with prior point clouds `priors` (n, H, W, 3):
        ({'pts3d', 'conf'}, {'pts3d_in_other_view', 'conf'})."""
        H, W = hw
        p = self.net["patch_size"]
        grid = (H // p, W // p)
        pos = _grid(*grid, feats.device)
        heads = self.net["dec_num_heads"]
        de = self.decoder_embed
        zc = lambda i, t: C.linear(P, "trunk", t, self.zero_convs[i][0].weight[:, :, 0],
                                   self.zero_convs[i][0].bias)
        pc = [self._embed(P, self.patch_embed_point_cloud, priors[idx]) for idx in (ii, jj)]
        f = [C.linear(P, "trunk", feats[idx], de.weight, de.bias) + zc(0, pc[s])
             for s, idx in enumerate((ii, jj))]
        hooks = {0: [feats[ii], feats[jj]]}
        n_pc = len(self.dec_blocks_pc)
        for layer in range(self.net["dec_depth"]):
            prev = f
            f = [self._dec_block(P, self.dec_blocks[layer], prev[0], prev[1], heads, pos),
                 self._dec_block(P, self.dec_blocks2[layer], prev[1], prev[0], heads, pos)]
            if layer < n_pc:
                pc = [self._block(P, self.dec_blocks_pc[layer], t, heads, pos) for t in pc]
                f = [f[s] + zc(layer + 1, pc[s]) for s in range(2)]
            hooks[layer + 1] = f
        L = self.net["dec_depth"]
        hk = [L * 2 // 4, L * 3 // 4]
        dn = lambda t: C.layernorm(t, self.dec_norm.weight, self.dec_norm.bias)
        res = []
        for s, head in enumerate((self.downstream_head1, self.downstream_head2)):
            tokens = [hooks[0][s], hooks[hk[0]][s], hooks[hk[1]][s], dn(hooks[L][s])]
            res.append(self._head(P, head.dpt, tokens, grid, hw))
        res[1]["pts3d_in_other_view"] = res[1].pop("pts3d")
        return res[0], res[1]

    # ------------------------------------------------------------- heads
    def _conv(self, P, m, x):
        if isinstance(m, nn.ConvTranspose2d):
            return C.conv_transpose2d(P, "heads", x, m.weight, m.bias, stride=m.stride[0])
        return C.conv2d(P, "heads", x, m.weight, m.bias, stride=m.stride[0],
                        padding=m.padding[0])

    def _unit(self, P, u, x):
        h = self._conv(P, u.conv1, F.relu(x))
        return self._conv(P, u.conv2, F.relu(h)) + x

    def _fuse(self, P, rn, x, skip=None):
        if skip is not None:
            x = x + self._unit(P, rn.resConfUnit1, skip)
        x = self._unit(P, rn.resConfUnit2, x)
        x = C.interp(x, x.shape[2] * 2, x.shape[3] * 2, align_corners=True)
        return self._conv(P, rn.out_conv, x)

    def _head(self, P, d, tokens, grid, hw):
        nh, nw = grid
        maps = [t.reshape(t.shape[0], nh, nw, -1).permute(0, 3, 1, 2) for t in tokens]
        ap, sc = d.act_postprocess, d.scratch
        ls = []
        for k, m in enumerate(maps):
            for layer in ap[k]:
                m = self._conv(P, layer, m)
            ls.append(self._conv(P, getattr(sc, f"layer{k + 1}_rn"), m))
        p4 = self._fuse(P, sc.refinenet4, ls[3])[:, :, :ls[2].shape[2], :ls[2].shape[3]]
        p3 = self._fuse(P, sc.refinenet3, p4, ls[2])
        p2 = self._fuse(P, sc.refinenet2, p3, ls[1])
        p1 = self._fuse(P, sc.refinenet1, p2, ls[0])
        x = self._conv(P, d.head[0], p1)
        x = C.interp(x, x.shape[2] * 2, x.shape[3] * 2, align_corners=True)
        x = F.relu(self._conv(P, d.head[2], x))
        out = self._conv(P, d.head[4], x)[:, :, :hw[0], :hw[1]].permute(0, 2, 3, 1)
        xyz = out[..., :3]
        dist = torch.sqrt(torch.clamp((xyz * xyz).sum(-1, keepdim=True), min=1e-12))
        pts = xyz / torch.clamp(dist, min=1e-8) * torch.expm1(torch.clamp(dist, max=40.0))
        conf = 1.0 + torch.exp(torch.clamp(out[..., 3], max=80.0))
        return {"pts3d": pts, "conf": conf}


def _grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([ys, xs], -1).reshape(h * w, 2)


def build(net, device="meta"):
    with torch.device(device):
        return Align3R(net).eval()
