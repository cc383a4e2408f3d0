"""Bit-exact reimplementations of the reference RNG streams.

``RanPark`` (Park-Miller minimal standard, reference src/random_park.cpp) and
``RanMars`` (Marsaglia, src/random_mars.cpp) drive velocity initialization and
thermostats; golden-log trajectory parity requires the identical streams,
including the Box-Muller save/second state and the Jenkins coordinate hash
(random_park.cpp:92-128) used by ``velocity ... loop geom``.

These run once at setup on the host; plain numpy is fine.  An own copy of
lidp_tpu/rng.py, held bit-exact to it by the tests.
"""

from __future__ import annotations

import math

import numpy as np

_IA = 16807
_IM = 2147483647
_AM = 1.0 / _IM
_IQ = 127773
_IR = 2836


class RanPark:
    """Scalar Park-Miller RNG, bit-identical to reference random_park.cpp."""

    def __init__(self, seed: int):
        if seed <= 0:
            raise ValueError("Invalid seed for Park random # generator")
        self.seed = seed
        self.save = False
        self.second = 0.0

    def uniform(self) -> float:
        k = self.seed // _IQ
        self.seed = _IA * (self.seed - k * _IQ) - _IR * k
        if self.seed < 0:
            self.seed += _IM
        return _AM * self.seed

    def gaussian(self) -> float:
        if not self.save:
            while True:
                v1 = 2.0 * self.uniform() - 1.0
                v2 = 2.0 * self.uniform() - 1.0
                rsq = v1 * v1 + v2 * v2
                if rsq < 1.0 and rsq != 0.0:
                    break
            fac = math.sqrt(-2.0 * math.log(rsq) / rsq)
            self.second = v1 * fac
            self.save = True
            return v2 * fac
        else:
            self.save = False
            return self.second

    def reset_geom(self, ibase: int, coord) -> None:
        """Re-seed from a user seed + atom coordinate (random_park.cpp:92)."""
        self.seed = int(_geom_hash_seeds(ibase, np.asarray([coord], np.float64))[0])
        for _ in range(5):
            self.uniform()
        self.save = False


def _jenkins_update(hash_, signed_byte):
    # The reference walks the bytes through a signed `char*`
    # (random_park.cpp:96-110): bytes >= 0x80 are sign-extended before the
    # unsigned add. Inputs here must already be sign-extended (mod 2^32).
    hash_ = (hash_ + signed_byte) & np.uint64(0xFFFFFFFF)
    hash_ = (hash_ + (hash_ << np.uint64(10))) & np.uint64(0xFFFFFFFF)
    hash_ = hash_ ^ (hash_ >> np.uint64(6))
    return hash_


def _sign_extend_u8(b):
    b = np.asarray(b, np.int64)
    return np.where(b >= 128, b - 256, b).astype(np.int64) & 0xFFFFFFFF


def _geom_hash_seeds(ibase: int, coords: np.ndarray) -> np.ndarray:
    """Vectorized Jenkins one-at-a-time hash of (seed, x, y, z) -> Park seeds.

    Byte-for-byte equivalent to RanPark::reset(int, double*)
    (random_park.cpp:92-128), including the 27-bit mask quirk (0x7ffffff).
    """
    n = coords.shape[0]
    seed_bytes = np.frombuffer(
        np.int32(ibase).tobytes(), dtype=np.uint8
    )  # little-endian, like x86 hosts
    coord_bytes = coords.astype("<f8").reshape(n, 3).view(np.uint8).reshape(n, 24)

    h = np.zeros(n, dtype=np.uint64)
    for b in seed_bytes:
        h = _jenkins_update(h, _sign_extend_u8(b).astype(np.uint64))
    for col in range(24):
        h = _jenkins_update(h, _sign_extend_u8(coord_bytes[:, col]).astype(np.uint64))
    h = (h + (h << np.uint64(3))) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(11))
    h = (h + (h << np.uint64(15))) & np.uint64(0xFFFFFFFF)
    seeds = (h & np.uint64(0x7FFFFFF)).astype(np.int64)
    seeds[seeds == 0] = 1
    return seeds


class VecRanPark:
    """Array of independent Park-Miller streams advanced in lockstep."""

    def __init__(self, seeds: np.ndarray):
        self.seed = seeds.astype(np.int64).copy()

    def uniform(self) -> np.ndarray:
        k = self.seed // _IQ
        self.seed = _IA * (self.seed - k * _IQ) - _IR * k
        self.seed = np.where(self.seed < 0, self.seed + _IM, self.seed)
        return _AM * self.seed

    def gaussian_pair(self):
        """One Box-Muller draw per stream with per-stream rejection."""
        n = self.seed.shape[0]
        first = np.zeros(n)
        second = np.zeros(n)
        pending = np.ones(n, bool)
        while pending.any():
            v1 = 2.0 * self.uniform() - 1.0
            v2 = 2.0 * self.uniform() - 1.0
            rsq = v1 * v1 + v2 * v2
            ok = pending & (rsq < 1.0) & (rsq != 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                fac = np.sqrt(-2.0 * np.log(rsq) / rsq)
            first = np.where(ok, v2 * fac, first)
            second = np.where(ok, v1 * fac, second)
            pending &= ~ok
        return first, second

    def gaussian3(self):
        """Three gaussians per stream in RanPark order (pair, saved, pair)."""
        g1, g2 = self.gaussian_pair()
        g3, _ = self.gaussian_pair()
        return g1, g2, g3

    def uniform3(self):
        return self.uniform(), self.uniform(), self.uniform()


def park_geom_streams(seed: int, coords: np.ndarray) -> VecRanPark:
    """Per-atom geometry-seeded streams (velocity loop geom), warmed up 5x."""
    v = VecRanPark(_geom_hash_seeds(seed, coords))
    for _ in range(5):
        v.uniform()
    return v


class RanMars:
    """Marsaglia RNG, bit-identical to reference random_mars.cpp."""

    def __init__(self, seed: int):
        if seed <= 0 or seed > 900000000:
            raise ValueError("Invalid seed for Marsaglia random # generator")
        self.save = False
        self.second = 0.0
        u = [0.0] * 98
        ij = (seed - 1) // 30082
        kl = (seed - 1) - 30082 * ij
        i = (ij // 177) % 177 + 2
        j = ij % 177 + 2
        k = (kl // 169) % 178 + 1
        l = kl % 169
        for ii in range(1, 98):
            s, t = 0.0, 0.5
            for _ in range(24):
                m = ((i * j) % 179) * k % 179
                i, j, k = j, k, m
                l = (53 * l + 1) % 169
                if (l * m) % 64 >= 32:
                    s += t
                t *= 0.5
            u[ii] = s
        self.u = u
        self.c = 362436.0 / 16777216.0
        self.cd = 7654321.0 / 16777216.0
        self.cm = 16777213.0 / 16777216.0
        self.i97 = 97
        self.j97 = 33
        self.uniform()

    def uniform(self) -> float:
        uni = self.u[self.i97] - self.u[self.j97]
        if uni < 0.0:
            uni += 1.0
        self.u[self.i97] = uni
        self.i97 -= 1
        if self.i97 == 0:
            self.i97 = 97
        self.j97 -= 1
        if self.j97 == 0:
            self.j97 = 97
        self.c -= self.cd
        if self.c < 0.0:
            self.c += self.cm
        uni -= self.c
        if uni < 0.0:
            uni += 1.0
        return uni

    def gaussian(self) -> float:
        if not self.save:
            while True:
                v1 = 2.0 * self.uniform() - 1.0
                v2 = 2.0 * self.uniform() - 1.0
                rsq = v1 * v1 + v2 * v2
                if rsq < 1.0 and rsq != 0.0:
                    break
            fac = math.sqrt(-2.0 * math.log(rsq) / rsq)
            self.second = v1 * fac
            self.save = True
            return v2 * fac
        else:
            self.save = False
            return self.second
