"""``jax.random``'s keyed threefry streams in plain torch, so that a seed
draws the JAX package's galaxy.

A standalone port of JAX 0.9's defaults (``jax_threefry_partitionable``,
the ``threefry2x32`` implementation): ``jax/_src/prng.py``
(``threefry_seed``, ``iota_2x32_shape``, ``threefry_2x32``,
``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_split``, ``_uniform``, ``_bernoulli``, ``_shuffle``, ``choice``,
``_normal_real``, ``_gamma_one``, ``_gamma_impl``).

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(torch's ``uint32`` lacks the shifts and xors these need). Every draw runs
on its key's device, or on ``device`` where a function is given one.
Every stage is built from operations that round the same on every device
(integer arithmetic; float32 and float64 add and multiply; divisions and
square roots taken in float64 and rounded to float32, since torch's CUDA
float32 ``sqrt`` is not correctly rounded), so a key draws the same bits on
the CPU and on a card:

- ``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``permutation``,
  ``choice``, ``uniform`` and ``bernoulli`` are JAX's bits;
- ``normal`` is XLA's float32 ``erf_inv`` on a uniform, with XLA's CPU
  ``log1p`` (Cephes' rational, then Cephes' ``logf``) and its contracted
  products (:func:`_fma`) written out: JAX 0.9's bits on the draws checked
  (3 x 3,538,944), and ``log`` XLA's on every float in [0.25, 1);
- ``gamma`` runs ``_gamma_one``'s loop with that ``normal`` and ``log``:
  JAX's bits on the draws checked (20,000 each for seeds 0, 42, 1042).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32 = torch.float32
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _on(key: torch.Tensor, device) -> torch.Tensor:
    if not isinstance(key, torch.Tensor):
        raise TypeError(f"a key is a tensor from prng.PRNGKey or prng.split, not {type(key)}")
    return key if device is None else key.to(device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & MASK)``
    of the seed as JAX's default 32-bit integer, so ``PRNGKey(-5)`` is
    ``(0, 4294967291)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key words
    ``(k1, k2)`` (20 rounds; all arguments int64 holding uint32, broadcast
    against each other)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _iota_2x32(shape: Tuple[int, ...], device, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the row-major index of every element as (high,
    low) 32-bit words, plus ``offset``; a shape-``()`` draw is counter
    ``(0, 0)``."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash(keys: torch.Tensor, shape: Tuple[int, ...], offset: int = 0):
    """Threefry of every counter of ``shape`` (starting at ``offset``) under
    every key of ``keys`` (``(..., 2)``): two words of shape
    ``keys.shape[:-1] + shape``."""
    hi, lo = _iota_2x32(shape, keys.device, offset)
    tail = (1,) * len(shape)
    k1 = keys[..., 0].reshape(keys.shape[:-1] + tail)
    k2 = keys[..., 1].reshape(keys.shape[:-1] + tail)
    return threefry_2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: Shape = 2, device=None) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, shape ``(*num, 2)``. A batch
    of keys ``(..., 2)`` splits each one, giving ``(..., *num, 2)``."""
    b1, b2 = _hash(_on(key, device), _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int, device=None) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    ``threefry_seed(uint32(data))`` = ``(0, data)``, for ``data`` in [0,
    2**32)."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data {data} is not a uint32")
    key = _on(key, device)
    b1, b2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]),
                           torch.full_like(key[..., 1], data))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape = (), device=None,
                offset: int = 0) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: ``bits1 ^ bits2`` of each counter, as
    int64 in [0, 2**32). A batch of keys draws ``shape`` under each one.

    ``offset`` draws the elements ``offset ..`` of a larger array of the
    same key instead (JAX's threefry is partitionable: an element's bits
    depend on its row-major index alone), so a rank can draw its rows of a
    global array."""
    b1, b2 = _hash(_on(key, device), _shape(shape), offset)
    return b1 ^ b2


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``max(minval, f * (maxval -
    minval) + minval)``, the range taken in float32 as JAX takes it and the
    product and sum contracted as XLA's CPU code contracts them
    (:func:`_fma`; ``offset`` as in :func:`random_bits`)."""
    f = _unit(random_bits(key, shape, device, offset))
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)  # exact float32 values as Python scalars
    return _fma(f, span, float(lo)).clamp_min(float(lo))


def bernoulli(key: torch.Tensor, p: float, shape: Shape = (), device=None,
              offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``): a float32
    uniform below ``p`` rounded to float32, as a bool tensor (``offset`` as
    in :func:`random_bits`)."""
    return uniform(key, shape, device=device, offset=offset) < float(np.float32(p))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code contracts it:
    the product is exact in float64, the sum rounds in float64 and then to
    float32 (a double rounding that differs from a fused one about once in
    2**29 draws)."""
    return (a.double() * b + c).float()


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b`` correctly rounded on every device: the float64
    quotient rounded to float32 is (53 >= 2 * 24 + 2 bits)."""
    return (a.double() / b.double()).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded on every device, through float64
    as :func:`_div`: torch's CUDA float32 ``sqrt`` is not (1 ulp off the
    correctly rounded root on 661 of 100,000 draws' ``w`` on an H100)."""
    return torch.sqrt(a.double()).float()


# Cephes' log1p rational (XLA's elemental ``log1p`` for |x| below sqrt(2) - 1)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes' logf polynomial, in the three parts XLA's CPU ``log`` evaluates
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x.double(), float(np.float32(c)))
    return p


def log(y: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` of positive normal numbers as XLA's CPU code computes
    it (Cephes' ``logf``, its products contracted), from exact operations
    only, so it gives the same bits on every device."""
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(_F32)  # in [0.5, 1)
    small = m < float(np.float32(0.707106781186547524))
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    xd = x.double()
    x2 = x * x
    x3 = (x2 * x).double()
    y0 = _fma(_fma(torch.full_like(xd, _LOG_P[0]), xd, _LOG_P[1]), xd, _LOG_P[2])
    y1 = _fma(_fma(torch.full_like(xd, _LOG_P[3]), xd, _LOG_P[4]), xd, _LOG_P[5])
    y2 = _fma(_fma(torch.full_like(xd, _LOG_P[6]), xd, _LOG_P[7]), xd, _LOG_P[8])
    # the last product is contracted with the exponent's rounded low part
    lo = (e * float(np.float32(-2.12194440e-4))).double()
    r = _fma(_fma(_fma(y0, x3, y1.double()), x3, y2.double()), x3, lo)
    x = _fma(x2, -0.5, xd)
    return _fma(e, 0.693359375, (x + r).double())


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` on (-1, 0] as XLA's CPU code computes it: Cephes'
    rational ``x - x^2/2 + x^3 P(x)/Q(x)`` for |x| < sqrt(2) - 1, else
    :func:`log` of ``1 + x``; same bits on every device."""
    x2 = x * x
    r = _div(_horner(x, _LOG1P_P), _horner(x, _LOG1P_Q))
    r = _fma(x2, -0.5, ((x * x2) * r).double())
    near = x + r
    return torch.where(x.abs() < 0.41421356237309504880, near,
                       log(torch.clamp(1.0 + x, min=float(np.finfo(np.float32).tiny))))


# XLA's float32 erf_inv (the CHLO decomposition that JAX lowers
# ``lax.erf_inv`` to): Giles' single-precision polynomials in w.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x*x)``; below 5 the
    polynomial in ``w - 2.5``, else the one in ``sqrt(w) - 3``, its steps
    contracted; times ``x``; ``±inf`` at ``|x| = 1``."""
    w = -log1p(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, _sqrt(w) - 3.0).double()
    f32 = lambda v: float(np.float32(v))
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, t, torch.where(lt, f32(a), f32(b)).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``, ``u``
    uniform on [nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return _SQRT2 * erf_inv(u)


def gamma(key: torch.Tensor, a: float, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)`` in float32 for ``a >= 1``.

    As ``_gamma_impl``: one key an element from ``split(key, n)``, then each
    element's Marsaglia-Tsang loop of ``_gamma_one``, run over the elements
    still in it until none is: each round splits its key three ways, draws
    scalar normals from the second until ``v = 1 + c x > 0`` and a scalar
    uniform from the third, and leaves the loop on the squeeze or the log
    test. The result is ``d V``."""
    if a < 1.0:
        raise NotImplementedError("gamma with a < 1 (the boosted draw) is not ported")
    shape = _shape(shape)
    n = math.prod(shape)
    keys = split(key, n, device)
    dev = keys.device
    alpha = np.float32(a)
    d32 = alpha - np.float32(1.0 / 3.0)
    c32 = np.float32(1.0 / 3.0) / np.sqrt(d32, dtype=np.float32)
    d, c = float(d32), float(c32)
    key = split(keys, 2)[:, 0]  # _gamma_one: key, subkey = _split(key)
    V = torch.ones(n, dtype=_F32, device=dev)
    active = torch.arange(n, device=dev)
    while active.numel():
        sub = split(key[active], 3)
        key[active] = sub[:, 0]
        # the inner loop: normals from the x key until v > 0
        xk = sub[:, 1]
        x = torch.zeros(active.numel(), dtype=_F32, device=dev)
        v = torch.full_like(x, -1.0)
        todo = torch.arange(active.numel(), device=dev)
        while todo.numel():
            kk = split(xk[todo], 2)
            xk[todo] = kk[:, 0]
            xi = normal(kk[:, 1])
            vi = _fma(xi, c, 1.0)
            x[todo], v[todo] = xi, vi
            todo = todo[vi <= 0.0]
        X = x * x
        Vr = v * v * v
        U = uniform(sub[:, 2])
        V[active] = Vr
        again = (U >= 1.0 - 0.0331 * (X * X)) & (
            log(U) >= X * 0.5 + d * ((1.0 - Vr) + log(Vr)))
        active = active[again]
    return (d * V).reshape(shape)


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` reordered by rounds
    of a stable sort on fresh 32-bit keys, ``ceil(3 ln n / ln(2**32 - 1))``
    rounds."""
    key = _on(key, device)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (), replace: bool = False,
           device=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)``: the first
    ``prod(shape)`` entries of :func:`permutation`."""
    if replace:
        raise NotImplementedError("choice with replacement is not ported")
    shape = _shape(shape)
    draws = math.prod(shape)
    if draws > n:
        raise ValueError(f"cannot take {draws} of {n} without replacement")
    return permutation(key, n, device)[:draws].reshape(shape)


__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "bernoulli",
           "normal", "gamma", "permutation", "choice", "erf_inv", "threefry_2x32"]
