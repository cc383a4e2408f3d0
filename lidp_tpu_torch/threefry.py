"""The counter-based random stream of jax.random (threefry2x32, the
partitionable layout) in torch: the stream the JAX package's fix langevin
and fix temp/csld draw from, so the port gives the same trajectories.

A key is a pair of 32-bit words (k1, k2), held as Python ints: the keys of
a run (PRNGKey(seed), fold_in(key, step)) are derived on the host and cost
no device work.  The bits of a draw are computed on the caller's device, on
int64 tensors masked to 32 bits, the element at flat index i from the
counter pair (i >> 32, i & 0xFFFFFFFF) as jax's iota_2x32_shape lays it
out; a 32-bit draw is the xor of the two output words, a 64-bit draw the
first word above the second.  A float draw takes the top mantissa bits of
its width with the exponent of 1.0 and subtracts 1 (jax.random._uniform),
so the bits and the uniforms agree with jax.random's bit for bit on any
device.  normal goes through torch.erfinv, which differs from XLA's
erf_inv by at most ~3e-13 (float64) and ~6e-6 (float32) relative.  The
scalar draws of fix temp/csvr (normal_scalar, gamma_draw) are formed on
the host as XLA's CPU code forms them, bit for bit (below).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of 20 rounds (jax's _threefry2x32_lowering)
    of the key (k1, k2) on the counters (x1, x2): Python ints or int64
    tensors holding values in [0, 2^32).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def prng_key(seed: int):
    """jax.random.PRNGKey(seed): the 64-bit seed's high and low words (a
    uint32 or non-negative int32 seed has high word 0; a negative int64
    seed is taken as its two's complement)."""
    seed = int(seed) % (1 << 64)
    return (seed >> 32, seed & MASK32)


def fold_in(key, data: int):
    """jax.random.fold_in(key, data), data taken as uint32: the hash of
    the counters (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def split(key, num: int = 2):
    """jax.random.split(key, num) (the partitionable, fold-like split):
    key i is the hash of the counters (i >> 32, i & MASK32)."""
    out = []
    for i in range(num):
        out.append(threefry2x32(key[0], key[1], i >> 32, i & MASK32))
    return out


def _words(key, shape, device):
    """The two output words of every element of a draw of `shape`, as
    int64 tensors of that shape."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return b1.reshape(shape), b2.reshape(shape)


def random_bits(key, bit_width: int, shape, device="cpu"):
    """jax.random.bits(key, shape, uint32 | uint64) as an int64 tensor:
    the 32-bit values, or the 64-bit patterns in two's complement."""
    b1, b2 = _words(key, shape, device)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        hi = b1 - ((b1 >> 31) << 32)      # the signed high word
        return (hi << 32) | b2
    raise ValueError(f"bit_width {bit_width}: 32 or 64")


def _unit_floats(key, shape, dtype, device):
    """The floats in [0, 1) of jax.random._uniform before its scaling:
    the draw's top nmant bits under the exponent of 1.0, less 1."""
    b1, b2 = _words(key, shape, device)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        f = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # the 64-bit draw (b1 << 32 | b2) shifted right by 12
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        f = bits.view(torch.float64)
    else:
        raise TypeError(f"uniform takes float32 or float64, not {dtype}")
    return f - 1.0


def uniform(key, shape, dtype=torch.float64, device="cpu", minval=0.0,
            maxval=1.0):
    """jax.random.uniform(key, shape, dtype, minval, maxval), bit for
    bit."""
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    f = _unit_floats(key, shape, dtype, device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def normal(key, shape, dtype=torch.float64, device="cpu"):
    """jax.random.normal(key, shape, dtype): sqrt(2) erfinv(u) of the
    uniform on (nextafter(-1, 0), 1)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(key, shape, dtype, device, minval=lo, maxval=1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2.0), dtype=dtype,
                                          device=device)


# ---- the scalar draws on the host: jax.random.gamma, bit for bit -------
#
# jax.random.gamma (jax._src.random._gamma_one) is Marsaglia-Tsang with a
# nested rejection loop that splits its key on every try.  Its value
# passes through XLA's CPU erf_inv (the Giles polynomials of the CHLO
# decomposition, on XLA's log1p: a Cephes rational near 0, log(1 + x)
# elsewhere), XLA's float32 log (a Cephes polynomial of its own) and the
# C library's float64 log and pow (which Python's math module calls), so
# the draw is computed here in numpy scalars of the draw's dtype, each
# operation in the order XLA's lowering performs it: the same bits as
# jax.random.gamma on the CPU.  It is a scalar draw from a host key, so it
# costs the device nothing; a caller on the card gets its bits too.

import ctypes
import ctypes.util
from fractions import Fraction

import numpy as np

_LIBM = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_LIBM.powf.restype = ctypes.c_float
_LIBM.powf.argtypes = [ctypes.c_float, ctypes.c_float]

# XLA's float32 log: Cephes logf's polynomial in Eigen's evaluation order
_LOGF = tuple(np.float32(c) for c in (
    0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
    -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
    0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
# log1p's rational for |x| < sqrt(2) - 1 (XLA's EmitLog1p, from Cephes)
_L1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_L1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
# erf_inv (M. Giles, "Approximating the erfinv function"): float32 for w
# below and above 5, float64 for w below 6.25, below 16 and above
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682))
_ERFINV64_625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_INF = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def _np_dtype(dtype):
    return np.float32 if dtype in (torch.float32, np.float32) \
        else np.float64


def _fma(a, b, c, T):
    """a*b + c rounded once to T, as the FMA instructions XLA's CPU code
    contracts its multiply-adds into."""
    q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = T(float(q))              # float64: correctly rounded already
    if T is np.float32 and np.isfinite(f):
        # float32: settle the double rounding against the neighbours,
        # ties to even
        def key(g):
            return (abs(Fraction(float(g)) - q),
                    int(np.array(g).view(np.int32)) & 1)
        f = min((f, np.nextafter(f, T(-np.inf)),
                 np.nextafter(f, T(np.inf))), key=key)
    return f


def _log(a, T):
    """XLA's CPU log of the scalar a of type T."""
    if T is np.float64:
        if a <= 0.0 or a != a:
            return T(-np.inf) if a == 0.0 else T(np.nan)
        return T(math.log(float(a)))
    if a == 0.0:
        return T(-np.inf)
    if not a > 0.0:
        return T(np.nan)
    if a == np.inf:
        return T(np.inf)
    y = max(a, T(np.finfo(np.float32).tiny))
    bits = int(np.array(y, np.float32).view(np.int32))
    m = np.array((bits & 0x7FFFFF) | 0x3F000000,
                 np.int32).view(np.float32)[()]
    e = T((bits >> 23) - 127) + T(1.0)
    lt = m < T(0.7071067690849304)
    x = (m + T(-1.0)) + (m if lt else T(0.0))
    e = e - (T(1.0) if lt else T(0.0))
    p = _LOGF
    z = x * x
    x3 = z * x
    y1 = _fma(_fma(x, p[0], p[1], T), x, p[2], T)
    y2 = _fma(_fma(x, p[3], p[4], T), x, p[5], T)
    y3 = _fma(_fma(x, p[6], p[7], T), x, p[8], T)
    y = _fma(_fma(y1, x3, y2, T), x3, y3, T)
    y = _fma(y, x3, e * T(-0.00021219444170128554), T)
    r = _fma(z, T(-0.5), x, T) + y
    return _fma(e, T(0.693359375), r, T)


def _poly(x, coeffs, T):
    """XLA's EvaluatePolynomial from a zero start: r*x + c, contracted
    past its first step (whose x*0 has two uses)."""
    r = x * T(0.0) + T(coeffs[0])
    for c in coeffs[1:]:
        r = _fma(r, x, T(c), T)
    return r


def _log1p(x, T):
    """XLA's log1p: the Cephes rational below sqrt(2) - 1, else
    log(x + 1)."""
    if abs(x) < T(0.41421356237309504880):
        x2 = x * x
        r = _poly(x, _L1P_NUM, T) / _poly(x, _L1P_DEN, T)
        return x + _fma(x2, T(-0.5), (x * x2) * r, T)
    return _log(x + T(1.0), T)


def _erf_inv(u, T):
    """XLA's erf_inv of the scalar u of type T (the CHLO decomposition)."""
    lg = _log1p(u * -u, T)       # -w
    if T is np.float32:
        small = lg > T(-5.0)
        w = (T(-2.5) - lg) if small else (np.sqrt(-lg) + T(-3.0))
        cs = _ERFINV32[0 if small else 1]
        p = T(cs[0])
        for c in cs[1:]:
            p = _fma(p, w, T(c), T)
    else:
        lt625, lt16 = lg > T(-6.25), lg > T(-16.0)
        if lt625:
            w = T(-3.125) - lg
        else:
            w = np.sqrt(-lg) - (T(3.25) if lt16 else T(5.0))

        def coef(i):
            if i < 17 and not lt16:
                return T(_ERFINV64_INF[i])
            if i < 19 and not lt625:
                return T(_ERFINV64_16[i])
            return T(_ERFINV64_625[i])

        p = coef(0)
        for i in range(1, 23):
            if i < 17 or (i < 19 and lt16) or lt625:
                p = _fma(p, w, coef(i), T)
    return u * (T(np.inf) if abs(u) == T(1.0) else p)


def _uniform_scalar(key, T, lo=0.0, hi=1.0):
    """jax.random.uniform(key, (), T, lo, hi) on the host: the unit
    float scaled by one contracted multiply-add, then max(lo, .)."""
    b1, b2 = threefry2x32(key[0], key[1], 0, 0)
    if T is np.float32:
        f = np.array(((b1 ^ b2) >> 9) | 0x3F800000,
                     np.uint32).view(np.float32)[()]
    else:
        bits = ((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000) \
            & 0xFFFFFFFFFFFFFFFF
        f = np.array(bits, np.uint64).view(np.float64)[()]
    lo, hi = T(lo), T(hi)
    return max(lo, _fma(f - T(1.0), hi - lo, lo, T))


def normal_scalar(key, dtype=torch.float64):
    """jax.random.normal(key, (), dtype) on the host, bit for bit with
    the CPU's: a numpy scalar of the dtype."""
    T = _np_dtype(dtype)
    lo = np.nextafter(T(-1.0), T(0.0))
    return _erf_inv(_uniform_scalar(key, T, lo, 1.0), T) * T(np.sqrt(2.0))


_RSQRT_STUB = None


def _hw_rsqrt_estimate(x, T):
    """The CPU's reciprocal square root estimate that XLA's rsqrt starts
    its Newton steps from (vrsqrt14pd for float64 under AVX-512, rsqrtss
    for float32), run as a two-instruction function; None where the CPU
    lacks it (then the caller takes 1/sqrt)."""
    global _RSQRT_STUB
    if _RSQRT_STUB is None:
        _RSQRT_STUB = {}
        try:
            import mmap
            import platform

            if platform.machine() not in ("x86_64", "AMD64"):
                raise OSError("not x86-64")
            with open("/proc/cpuinfo") as fh:
                flags = fh.read()
            buf = mmap.mmap(-1, mmap.PAGESIZE, prot=mmap.PROT_READ
                            | mmap.PROT_WRITE | mmap.PROT_EXEC)
            # rsqrtss xmm0, xmm0; ret | vrsqrt14pd xmm0, xmm0; ret
            buf.write(bytes([0xF3, 0x0F, 0x52, 0xC0, 0xC3, 0x90, 0x90, 0x90,
                             0x62, 0xF2, 0xFD, 0x08, 0x4E, 0xC0, 0xC3]))
            base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
            _RSQRT_STUB["buf"] = buf
            _RSQRT_STUB[np.float32] = ctypes.CFUNCTYPE(
                ctypes.c_float, ctypes.c_float)(base)
            if " avx512f" in flags and " avx512vl" in flags:
                _RSQRT_STUB[np.float64] = ctypes.CFUNCTYPE(
                    ctypes.c_double, ctypes.c_double)(base + 8)
        except (OSError, ValueError):
            pass
    fn = _RSQRT_STUB.get(T)
    return None if fn is None else T(fn(float(x)))


def _rsqrt(x, T):
    """XLA's CPU rsqrt: the hardware estimate and two Newton steps, each
    y + (-y/2)(x y y - 1) contracted into two FMAs."""
    y = _hw_rsqrt_estimate(x, T)
    if y is None:
        return T(1.0) / np.sqrt(x)
    for _ in range(2):
        y = _fma(y * T(-0.5), _fma(x * y, y, T(-1.0), T), y, T)
    return y


def gamma_draw(key, alpha, dtype=torch.float64):
    """jax.random.gamma(key, alpha, dtype=dtype) for a scalar alpha, on
    the host, as XLA's CPU code computes an eager call: (the draw as a
    numpy scalar of the dtype, the number of tries of the rejection
    loop).  Where a multiply-add contracts or XLA rewrites an operation
    (1/3 / sqrt(d) into 1/3 * rsqrt(d)), the same is done here."""
    T = _np_dtype(dtype)
    alpha = T(alpha)
    key = split(key, 1)[0]       # _gamma_impl's split to a's shape
    one = T(1.0)
    boost = alpha >= one
    a = alpha if boost else alpha + one
    third = T(1.0 / 3.0)
    d = a + T(-1.0 / 3.0)
    c = _rsqrt(d, T) * third
    key, subkey = split(key)
    X, V, U = T(0.0), one, T(2.0)
    tries = 0
    while (U >= one - T(0.0331) * (X * X)) and (
            _log(U, T) >= X * T(0.5) + d * ((one - V) + _log(V, T))):
        tries += 1
        key, x_key, u_key = split(key, 3)
        x, v = T(0.0), T(-1.0)
        while v <= T(0.0):
            x_key, sub = split(x_key)
            x = normal_scalar(sub, T)
            v = _fma(x, c, one, T)
        X, V = x * x, (v * v) * v
        U = _uniform_scalar(u_key, T)
    out = d * V
    if not boost:
        s = one - _uniform_scalar(subkey, T)
        e = one / alpha
        s = (T(_LIBM.powf(float(s), float(e))) if T is np.float32
             else T(math.pow(float(s), float(e))))
        out = out * s
    return out, tries


def gamma(key, alpha, dtype=torch.float64, device="cpu"):
    """jax.random.gamma(key, alpha, dtype=dtype) for a scalar alpha as a
    0-d tensor on `device`, drawn on the host (gamma_draw)."""
    return torch.tensor(gamma_draw(key, alpha, dtype)[0], dtype=dtype,
                        device=device)
