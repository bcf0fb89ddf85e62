"""Operations and bytes of the KL-VAE f8 (taming-transformers' Encoder
and Decoder), walked from its widths: every convolution (2 operations a
multiply-add over its output pixels), the mid block's attention (its
four 1x1 convolutions and its two products). Bytes: the weights in the
served dtype, the input and the output once."""


def _conv(hw, cin, cout, k):
    return 2 * hw * cin * cout * k * k


def _res(hw, cin, cout):
    return _conv(hw, cin, cout, 3) + _conv(hw, cout, cout, 3) + (
        _conv(hw, cin, cout, 1) if cin != cout else 0)


def _mid(hw, c):
    return 2 * _res(hw, c, c) + 4 * _conv(hw, c, c, 1) + 4 * hw * hw * c


def _params(arch, encoder):
    ch, mult, nrb, z = arch["ch"], arch["ch_mult"], arch["num_res_blocks"], arch["z_channels"]
    conv = lambda cin, cout, k: cin * cout * k * k + cout
    res = lambda cin, cout: 2 * cin + conv(cin, cout, 3) + 2 * cout + conv(cout, cout, 3) + (
        conv(cin, cout, 1) if cin != cout else 0)
    top = ch * mult[-1]
    mid = 2 * res(top, top) + 2 * top + 4 * conv(top, top, 1)
    total = mid + 2 * (ch * mult[0] if not encoder else top)
    if encoder:
        total += conv(3, ch, 3) + conv(top, 2 * z, 3) + conv(2 * z, 2 * z, 1)
        cin = ch
        for lvl, m in enumerate(mult):
            for _ in range(nrb):
                total += res(cin, ch * m)
                cin = ch * m
            if lvl < len(mult) - 1:
                total += conv(cin, cin, 3)
    else:
        total += conv(z, top, 3) + conv(ch * mult[0], 3, 3) + conv(z, z, 1)
        cin = top
        for lvl in reversed(range(len(mult))):
            for _ in range(nrb + 1):
                total += res(cin, ch * mult[lvl])
                cin = ch * mult[lvl]
            if lvl:
                total += conv(cin, cin, 3)
    return total


def decoder(arch, chunks: int, itemsize: int = 2, latent: int = 16) -> dict:
    """``Decoder.forward`` on ``chunks`` (4, 16, 16) latents."""
    ch, mult, nrb, z = arch["ch"], arch["ch_mult"], arch["num_res_blocks"], arch["z_channels"]
    side = latent
    cin = ch * mult[-1]
    flops = _conv(side * side, z, cin, 3) + _mid(side * side, cin)
    for lvl in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            flops += _res(side * side, cin, ch * mult[lvl])
            cin = ch * mult[lvl]
        if lvl:
            side *= 2
            flops += _conv(side * side, cin, cin, 3)
    flops += _conv(side * side, cin, 3, 3)
    nbytes = (_params(arch, False) + chunks * (z * latent * latent + 3 * side * side)) * itemsize
    return {"flops": chunks * flops, "bytes": nbytes}


def encoder(arch, chunks: int, itemsize: int = 2, side: int = 128) -> dict:
    """``Encoder.forward`` on ``chunks`` (3, 128, 128) rolls."""
    ch, mult, nrb, z = arch["ch"], arch["ch_mult"], arch["num_res_blocks"], arch["z_channels"]
    flops = _conv(side * side, 3, ch, 3)
    cin, s = ch, side
    for lvl, m in enumerate(mult):
        for _ in range(nrb):
            flops += _res(s * s, cin, ch * m)
            cin = ch * m
        if lvl < len(mult) - 1:
            s //= 2
            flops += _conv(s * s, cin, cin, 3)
    flops += _mid(s * s, cin) + _conv(s * s, cin, 2 * z, 3)
    nbytes = (_params(arch, True) + chunks * (3 * side * side + 2 * z * s * s)) * itemsize
    return {"flops": chunks * flops, "bytes": nbytes}


def groupnorm_swish(numel: int, channels: int, itemsize: int = 2) -> dict:
    """One fused GroupNorm + swish: x read once, y written once, the
    scale and shift once; about ten operations an element."""
    return {"flops": 10 * numel, "bytes": (2 * numel + 2 * channels) * itemsize}
