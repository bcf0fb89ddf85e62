"""DiffCollage: long-form generation by stitching a window denoiser's scores.

Port of ``rule_guided_music_tpu/diffusion/collage.py`` (reference
diff_collage/{w_img.py, condind_long.py, condind_circle.py, w_loss.py}).
The long latent is (B, C, T_long, P) with time on axis -2; it is cut into
overlapping windows of ``base`` columns, window index fastest in the batch,
and the per-window denoiser runs once on all (B*n) windows. The stitched
closure has the denoiser's signature, so the sampler takes it as its
``model_fn``.

The loss-guided workers differentiate through the window denoiser. The
sampler runs under ``torch.no_grad()``, so each turns grad mode on for a
detached copy of its input and calls ``torch.autograd.grad``, where the JAX
package calls ``jax.grad``. They run the denoiser once with a gradient and
reuse that output for the returned epsilon and the optimal weight, where
the JAX package runs it again without one: the values are the same.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

BASE_LEN = 128  # window length in latent columns (w_img.py:12)


def linear_length(num_img: int, overlap: int, base: int = BASE_LEN) -> int:
    return base * num_img - overlap * (num_img - 1)


def circle_length(num_img: int, overlap: int, base: int = BASE_LEN) -> int:
    # a circle uses num_img + 1 windows over a wrapped latent (condind_circle.py:8-15)
    n = num_img + 1
    return base * n - overlap * n


def split_windows(x: torch.Tensor, n: int,
                  base: int = BASE_LEN) -> Tuple[torch.Tensor, int]:
    """(B, C, T_long, P) -> ((B*n, C, base, P) windows, overlap)."""
    b, c, t_long, p = x.shape
    overlap = (n * base - t_long) // (n - 1)
    assert n * base - overlap * (n - 1) == t_long, (n, base, overlap, t_long)
    stride = base - overlap
    wins = torch.stack([x[:, :, i * stride:i * stride + base, :]
                        for i in range(n)], dim=1)
    return wins.reshape(b * n, c, base, p), overlap


def merge_windows(wins: torch.Tensor, overlap: int, n: int,
                  is_avg: bool = True) -> torch.Tensor:
    """(B*n, C, base, P) -> (B, C, T_long, P): window i added after window
    i-1, then divided by the overlap counts where ``is_avg``
    (avg_merge_wimg)."""
    bn, c, base, p = wins.shape
    b = bn // n
    t_long = n * base - (n - 1) * overlap
    stride = base - overlap
    wins = wins.reshape(b, n, c, base, p)
    out = torch.zeros((b, c, t_long, p), dtype=wins.dtype, device=wins.device)
    count = torch.zeros((1, 1, t_long, 1), dtype=wins.dtype, device=wins.device)
    for i in range(n):
        sl = slice(i * stride, i * stride + base)
        out[:, :, sl, :] += wins[:, i]
        count[:, :, sl, :] += 1.0
    return out / count if is_avg else out


def _wrap(x: torch.Tensor, overlap: int) -> torch.Tensor:
    """A circle's latent with its first ``overlap`` columns appended."""
    return torch.cat([x, x[:, :, :overlap, :]], dim=2)


def _fold_circle(merged: torch.Tensor, overlap: int) -> torch.Tensor:
    """Close a merged circle: the head is the mean of the first and last
    ``overlap`` columns, which the wrap made the same positions."""
    head = (merged[:, :, :overlap, :] + merged[:, :, -overlap:, :]) / 2.0
    return torch.cat([head, merged[:, :, overlap:-overlap, :]], dim=2)


def _repeat(v, n: int):
    return torch.repeat_interleave(v, n, dim=0) if v is not None else None


def _cond_ind_merge(full_eps: torch.Tensor, half_eps: torch.Tensor, b: int,
                    n: int, overlap: int, circle: bool) -> torch.Tensor:
    """Full-window scores minus the half-window (overlap) scores of each
    window's trailing overlap, the last window's excepted, summed over the
    long latent."""
    half_eps = half_eps.reshape(b, n, *half_eps.shape[1:]).clone()
    # the last window's trailing overlap has no successor factor
    half_eps[:, -1] = 0.0
    full_eps = full_eps.reshape(b, n, *full_eps.shape[1:]).clone()
    full_eps[:, :, :, -overlap:, :] += -half_eps
    merged = merge_windows(full_eps.reshape(b * n, *full_eps.shape[2:]),
                           overlap, n, is_avg=False)
    return _fold_circle(merged, overlap) if circle else merged


def make_cond_ind_eps_fn(eps_fn: Callable, num_img: int, overlap: int,
                         circle: bool = False, base: int = BASE_LEN) -> Callable:
    """The stitched long-score closure ``long_eps(x, t, y)`` on
    (B, C, T_long, P), from the window denoiser ``eps_fn(x, t, y)`` on
    (N, C, base, P). Linear chain: condind_long.py:24-51; circle:
    condind_circle.py:41-84."""
    n = num_img + 1 if circle else num_img

    def long_eps(x: torch.Tensor, t: torch.Tensor, y=None) -> torch.Tensor:
        x_ext = _wrap(x, overlap) if circle else x
        wins, ov = split_windows(x_ext, n, base)
        assert ov == overlap, (ov, overlap)
        t_rep, y_rep = _repeat(t, n), _repeat(y, n)
        full_eps = eps_fn(wins, t_rep, y_rep)                # (B*n, C, base, P)
        half_eps = eps_fn(wins[:, :, -overlap:, :], t_rep, y_rep)
        return _cond_ind_merge(full_eps, half_eps, x.shape[0], n, overlap,
                               circle)

    return long_eps


def make_avg_eps_fn(eps_fn: Callable, num_img: int, overlap: int,
                    circle: bool = False, base: int = BASE_LEN) -> Callable:
    """Naive averaging baseline (diff_collage/avg_long.py:7-40,
    avg_circle.py): window scores averaged over the overlaps, with no
    conditional-independence correction."""
    n = num_img + 1 if circle else num_img

    def long_eps(x: torch.Tensor, t: torch.Tensor, y=None) -> torch.Tensor:
        x_ext = _wrap(x, overlap) if circle else x
        wins, _ = split_windows(x_ext, n, base)
        merged = merge_windows(eps_fn(wins, _repeat(t, n), _repeat(y, n)),
                               overlap, n, is_avg=True)
        return _fold_circle(merged, overlap) if circle else merged

    return long_eps


def make_loss_guided_eps_fn(eps_fn: Callable, num_img: int, overlap: int,
                            weight: float = 1.0) -> Callable:
    """Loss-guided stitching (diff_collage/w_loss.py:40-120): ``num_img``
    independent window states (B, num_img, C, base, P) diffuse together,
    each window's epsilon corrected by ``weight * sigma`` times the gradient
    of sum ||x̂0[i][-ov:] - x̂0[i+1][:ov]||², with x̂0 = x - sigma * eps."""

    def stacked_eps(x: torch.Tensor, sigma: torch.Tensor, y=None) -> torch.Tensor:
        b, n, c, base_len, p = x.shape
        assert n == num_img, (n, num_img)
        flat = x.reshape(b * n, c, base_len, p)
        sig_rep, y_rep = _repeat(sigma, n), _repeat(y, n)
        sig_b = sig_rep.reshape((-1,) + (1,) * (flat.ndim - 1))
        with torch.enable_grad():
            x_in = flat.detach().requires_grad_()
            eps = eps_fn(x_in, sig_rep, y_rep)
            x0w = (x_in - sig_b * eps).reshape(b, n, c, base_len, p)
            loss = ((x0w[:, :-1, :, -overlap:, :]
                     - x0w[:, 1:, :, :overlap, :]) ** 2).sum()
            grad = torch.autograd.grad(loss, x_in)[0]
        eps = eps.detach() + weight * sig_b * grad
        return eps.reshape(b, n, c, base_len, p)

    return stacked_eps


def make_cond_ind_sr_eps_fn(eps_fn: Callable, num_img: int, overlap: int,
                            low_res: torch.Tensor, circle: bool = False,
                            base: int = BASE_LEN) -> Callable:
    """Super-resolution stitching (condind_long.py:56-120 CondIndSR,
    condind_circle.py CondIndCircleSR): each window's denoiser
    ``eps_fn(x, t, y, low)`` sees the matching window of the
    low-resolution latent ``low_res`` (B, C, T_low, P_low)."""
    n = num_img + 1 if circle else num_img
    t_low = low_res.shape[2]

    def long_eps(x: torch.Tensor, t: torch.Tensor, y=None) -> torch.Tensor:
        x_ext = _wrap(x, overlap) if circle else x
        low_base = base * t_low // (x.shape[2] + (overlap if circle else 0))
        low_overlap = overlap * low_base // base
        low_ext = _wrap(low_res, low_overlap) if circle else low_res
        wins, _ = split_windows(x_ext, n, base)
        low_wins, _ = split_windows(low_ext, n, low_base)
        t_rep, y_rep = _repeat(t, n), _repeat(y, n)
        full_eps = eps_fn(wins, t_rep, y_rep, low_wins)
        half_eps = eps_fn(wins[:, :, -overlap:, :], t_rep, y_rep,
                          low_wins[:, :, -low_overlap:, :])
        return _cond_ind_merge(full_eps, half_eps, x.shape[0], n, overlap,
                               circle)

    return long_eps


# ---------------------------------------------------------------------------
# The EDM loss-guided workers (diff_collage/w_loss.py:94-432), which pair
# with diffusion/edm.py's sigma-space Heun sampler: each wraps a
# sigma-parameterized ``eps_fn(x, sigma, y)`` and corrects epsilon by the
# gradient of a consistency loss on x̂0 = x - sigma * eps, with the
# closed-form least-squares step weight (w_loss.py:111-125, 179-190).
# ---------------------------------------------------------------------------


def _optimal_weight(delta_pixel: torch.Tensor, delta_grad: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """argmin_w ||delta_pixel - w * delta_grad||², in float32."""
    delta_pixel, delta_grad = delta_pixel.float(), delta_grad.float()
    num = (delta_pixel * delta_grad).sum()
    den = (delta_grad * delta_grad).sum()
    return num / (den + eps)


def _loss_guided(eps_fn: Callable, x: torch.Tensor, sigma: torch.Tensor, y,
                 loss_of: Callable, weight_of: Callable,
                 weight: Union[float, str]) -> torch.Tensor:
    """eps + w * grad / max(sigma, 1e-8), with grad the gradient of
    ``loss_of(x̂0)`` with respect to x and w the fixed ``weight`` or, for
    "optimal", ``weight_of(x̂0, grad)``; x0_cor = x0 - w * grad
    (w_loss.py:59)."""
    sig_b = sigma.reshape((-1,) + (1,) * (x.ndim - 1))
    with torch.enable_grad():
        x_in = x.detach().requires_grad_()
        eps = eps_fn(x_in, sigma, y)
        x0 = x_in - sig_b * eps
        grad = torch.autograd.grad(loss_of(x0), x_in)[0]
    eps, x0 = eps.detach(), x0.detach()
    if weight == "optimal":
        w = weight_of(x0, grad)
    else:
        w = torch.tensor(weight, dtype=x.dtype, device=x.device)
    return eps + w * grad / torch.clamp(sig_b, min=1e-8)


def make_seq_extend_eps_fn(eps_fn: Callable, src_img: torch.Tensor,
                           overlap: int, weight: Union[float, str] = "optimal",
                           ratio: float = 1.0) -> Callable:
    """SeqWorker (w_loss.py:94-125): continue the fixed source excerpt
    ``src_img`` (B, C, T_src, P); the window's head is pulled to the
    source's tail by loss ||src[..., -ov:, :] - x̂0[..., :ov, :]||²."""
    src_tail = src_img[:, :, -overlap:, :]

    def loss_of(x0):
        return ((src_tail - x0[:, :, :overlap, :]) ** 2).sum()

    def weight_of(x0, grad):
        return _optimal_weight(x0[:, :, :overlap, :] - src_tail,
                               grad[:, :, :overlap, :]) * ratio

    def guided_eps(x: torch.Tensor, sigma: torch.Tensor, y=None) -> torch.Tensor:
        return _loss_guided(eps_fn, x, sigma, y, loss_of, weight_of, weight)

    return guided_eps


def seq_x0_replace(x0: torch.Tensor, src_img: torch.Tensor,
                   overlap: int) -> torch.Tensor:
    """SeqWorker.x0_replace (w_loss.py:106-109): the head replaced by the
    source's tail."""
    x0 = x0.clone()
    x0[:, :, :overlap, :] = src_img[:, :, -overlap:, :]
    return x0


def _seam_guided(eps_fn: Callable, overlap: int, weight: Union[float, str],
                 match_patch: Callable) -> Callable:
    """A worker whose loss is sum (tail - head)² over the pairs that
    ``match_patch`` gives, and whose optimal weight fits the seam's
    difference with the gradient's."""

    def loss_of(x0):
        tail, head = match_patch(x0)
        return ((tail - head) ** 2).sum()

    def weight_of(x0, grad):
        tail, head = match_patch(x0)
        g_tail, g_head = match_patch(grad)
        return _optimal_weight(tail - head, g_tail - g_head)

    def guided_eps(x: torch.Tensor, sigma: torch.Tensor, y=None) -> torch.Tensor:
        return _loss_guided(eps_fn, x, sigma, y, loss_of, weight_of, weight)

    return guided_eps


def make_circle_loss_eps_fn(eps_fn: Callable, overlap: int,
                            weight: Union[float, str] = "optimal") -> Callable:
    """CircleWorker (w_loss.py:127-190): the batch is a ring of windows,
    window i's head matched to window i-1's tail (rolled along the batch),
    so the batch closes into one circular long score."""

    def match_patch(a):
        return torch.roll(a[:, :, -overlap:, :], 1, dims=0), a[:, :, :overlap, :]

    return _seam_guided(eps_fn, overlap, weight, match_patch)


def circle_merge_batch(x: torch.Tensor, overlap: int) -> torch.Tensor:
    """CircleWorker.merge_circle_image (w_loss.py:155-163): a ring batch of
    B windows folded into one circular long latent, the seam averaged."""
    merged = merge_windows(x, overlap, x.shape[0], is_avg=True)
    return _fold_circle(merged, overlap)


def make_para_loss_eps_fn(eps_fn: Callable, overlap: int,
                          weight: Union[float, str] = "optimal") -> Callable:
    """ParaWorker (w_loss.py:226+): the batch is a chain of windows, window
    i's head matched to window i-1's tail with no wraparound."""

    def match_patch(a):
        return a[:-1, :, -overlap:, :], a[1:, :, :overlap, :]

    return _seam_guided(eps_fn, overlap, weight, match_patch)
