"""Operations and bytes of DiTRotary (the denoiser), from its widths.

Counts matrix products only (2 operations a multiply-add): the token MLP
embedding, the timestep MLP, per block the adaLN linear (one row per
sample), qkv, the two attention products, proj and the MLP, then the
final layer. Bytes count each input once and each output once: the
weights in the served dtype, x and the float32 output.
"""


def tokens(arch) -> int:
    h, w = arch["input_size"]
    return h * w // arch["patch_size"]


def params(arch) -> int:
    c, p, i = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    out = i * (2 if arch.get("learn_sigma") else 1)
    embed = (i * p * 256 + 256) + (256 * c + c) + (256 * c + c) + (c * c + c)
    labels = (arch["num_classes"] + 1) * c if arch["num_classes"] else 0
    block = (3 * c * c + 3 * c) + (c * c + c) + (8 * c * c + 5 * c) + (6 * c * c + 6 * c)
    final = (c * p * out + p * out) + (2 * c * c + 2 * c)
    return embed + labels + arch["depth"] * block + final


def attention(batch: int, n: int, c: int, itemsize: int = 2) -> dict:
    """One ``Attention.forward``: qkv, rotary, the kernel, proj."""
    flops = 2 * batch * n * c * 4 * c + 4 * batch * n * n * c
    nbytes = (2 * batch * n * c + 4 * c * c + 4 * c) * itemsize
    return {"flops": flops, "bytes": nbytes}


def forward(arch, batch: int, itemsize: int = 2) -> dict:
    """One ``DiTRotary.forward`` at ``batch``."""
    c, p, i = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    n = tokens(arch)
    out = i * (2 if arch.get("learn_sigma") else 1)
    embed = 2 * batch * n * (i * p * 256 + 256 * c) + 2 * batch * (256 * c + c * c)
    block = 2 * batch * n * 12 * c * c + 4 * batch * n * n * c + 2 * batch * 6 * c * c
    final = 2 * batch * 2 * c * c + 2 * batch * n * c * p * out
    h, w = arch["input_size"]
    nbytes = params(arch) * itemsize + batch * i * h * w * 4 + batch * out * h * w * 4
    return {"flops": embed + arch["depth"] * block + final, "bytes": nbytes}


def train_step(arch, batch: int) -> dict:
    """Forward and backward (input and weight gradients) at ``batch``:
    three forwards' products."""
    f = forward(arch, batch, 4)
    return {"flops": 3 * f["flops"], "bytes": f["bytes"]}
