"""Where ``UNet2DConditionModel`` normalises: the shape of each GroupNorm
call of its forward, which the GroupNorm kernels' tests and
``chip_smoke.py`` time and check at."""

from __future__ import annotations


def unet_gn_sites(cfg, size):
    """(hw, channels, activation) of every GroupNorm of
    ``UNet2DConditionModel(cfg).forward`` at a ``size`` x ``size`` sample,
    in call order (the model's own channel and resolution walk)."""
    ch = list(cfg.block_out_channels)
    sites = []

    def resnet(c_in, c_out, hw):
        sites.extend([(hw, c_in, "silu"), (hw, c_out, "silu")])

    def attn(c, hw):
        sites.append((hw, c, None))

    hw, cur, skips = size * size, ch[0], [ch[0]]
    for level, out_c in enumerate(ch):
        for _ in range(cfg.layers_per_block):
            resnet(cur, out_c, hw)
            if level >= len(ch) - 2:
                attn(out_c, hw)
            cur = out_c
            skips.append(cur)
        if level < len(ch) - 1:
            hw //= 4
            skips.append(cur)
    resnet(cur, cur, hw)
    attn(cur, hw)
    resnet(cur, cur, hw)
    for level, out_c in enumerate(reversed(ch)):
        for _ in range(cfg.layers_per_block + 1):
            resnet(cur + skips.pop(), out_c, hw)
            if level < 2:
                attn(out_c, hw)
            cur = out_c
        if level < len(ch) - 1:
            hw *= 4
    sites.append((hw, cur, "silu"))
    return sites
