"""Operations and bytes of the rotary DiT classifiers of classifier
guidance (a CLS token and 256 patch tokens), from their widths."""


def tokens(arch) -> int:
    h, w = arch["input_size"]
    return h * w // arch["patch_size"] + 1


def _head(arch, batch, key=True):
    """The bottleneck heads: one on CLS; the chord variant adds the key
    head on CLS (``key``) and runs the chord head on each of its windows."""
    c, nc = arch["hidden_size"], arch["num_classes"]
    mlp = lambda rows, out: 2 * rows * (c * (c // 4) + (c // 4) * out)
    if not arch.get("chord"):
        return mlp(batch, nc)
    windows = arch["input_size"][0] // arch["input_size"][1]
    return (mlp(batch, 25) if key else 0) + mlp(batch * windows, nc)


def _params(arch) -> int:
    c, p, i = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    head = lambda out: c * (c // 4) + c // 4 + (c // 4) * out + out + 2 * c
    heads = head(arch["num_classes"]) + (head(25) if arch.get("chord") else 0)
    block = 18 * c * c + 15 * c
    return (i * p * 256 + 256 + 256 * c + c + c + 256 * c + c + c * c + c
            + arch["depth"] * block + heads)


def forward(arch, batch: int, itemsize: int = 2) -> dict:
    c, p, i = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    n = tokens(arch)
    embed = 2 * batch * (n - 1) * (i * p * 256 + 256 * c) + 2 * batch * (256 * c + c * c)
    block = 2 * batch * n * 12 * c * c + 4 * batch * n * n * c + 2 * batch * 6 * c * c
    h, w = arch["input_size"]
    nbytes = _params(arch) * itemsize + batch * i * h * w * 4
    return {"flops": embed + arch["depth"] * block + _head(arch, batch), "bytes": nbytes}


def input_grad(arch, batch: int, itemsize: int = 2) -> dict:
    """The backward to the input alone (no weight gradient): each token
    linear's and the heads' dX products, and twice the attention products
    (dP, dS K, dS^T Q, P^T dO); the adaLN path carries no gradient, nor
    the chord variant's key head, which guidance does not read."""
    c, p, i = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    n = tokens(arch)
    embed = 2 * batch * (n - 1) * (i * p * 256 + 256 * c)
    block = 2 * batch * n * 12 * c * c + 8 * batch * n * n * c
    f = forward(arch, batch, itemsize)
    return {"flops": embed + arch["depth"] * block + _head(arch, batch, key=False),
            "bytes": f["bytes"]}
