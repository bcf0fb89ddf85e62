"""The cell's CUDA libraries built at once: the port builds each source
with ``nvcc`` at its first call, one after another; set-up starts every
library the traffic names together, so the first run of a checkout pays
the longest build rather than their sum. Later runs load what the
checkout's ``_build/`` holds."""

from concurrent.futures import ThreadPoolExecutor


def prebuild(names, device) -> None:
    if device.type != "cuda" or not names:
        return
    from rule_guided_music_tpu_torch.ops import flash_attention as fa
    from rule_guided_music_tpu_torch.ops import groupnorm_swish as gn

    loaders = {name: (lambda n=name: fa._load(n)) for name in fa.LIBRARIES}
    loaders["groupnorm_swish"] = gn._load
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for f in [pool.submit(loaders[n]) for n in names]:
            f.result()
