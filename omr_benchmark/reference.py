"""The plain reference of InstantOMR: key generation, clues, detection and
the digest encoders, in plain PyTorch on int64 tensors.

This module is the benchmark's own yardstick. It imports nothing of the
program under test: its arithmetic is a frozen copy of the plain torch path
the program was first written as (exact modular products over
``q = 2**bits - eps``, the radix-2 negacyclic NTT composed with the slot
order of the reference ``PallasNtt``/``PallasNtt50`` plan, the signed
gadget, the paired blind rotation, the LWE key switch and the homomorphic
trace), after the reference ``omr_core`` crate. The benchmark makes every
input with it (secrets, keys, clues) and hands the same tensors to the
program, and after a run it works out again what the program computed.

Everything is exact integer arithmetic: the program's outputs are compared
word for word. ``ks_dtype`` exists for the control only: the key switch's
sums run as a float64 matrix product (every partial sum is an integer below
2**53), and the control runs the same product in float32.
"""

from __future__ import annotations

import numpy as np
import torch

_I64 = torch.int64


# ------------------------------------------------------------------ fields
class Field:
    """Exact arithmetic mod a prime ``q = 2**bits - eps`` (bits <= 50) on
    int64 tensors: ``*`` wraps mod 2**64, ``>>`` is arithmetic."""

    SMALL_SHOUP_SHIFT = 30
    BIG_SHOUP_SHIFT = 52

    def __init__(self, q: int):
        self.q = int(q)
        self.bits = q.bit_length()
        self.eps = (1 << self.bits) - q
        if self.bits > 50 or self.eps >= 1 << (self.bits // 2):
            raise ValueError(f"modulus {q} is not a Solinas-like prime of <= 50 bits")
        self.small = self.bits <= 31
        self.mid = 31 < self.bits <= 38
        if not (self.small or self.mid or 46 <= self.bits <= 50):
            raise ValueError(f"no product for {self.bits}-bit moduli")
        self.small_shoup = self.bits <= 28
        self.mask = (1 << self.bits) - 1
        self.shoup_shift = self.SMALL_SHOUP_SHIFT if self.small_shoup else self.BIG_SHOUP_SHIFT

    def shoup(self, w: torch.Tensor) -> torch.Tensor:
        """``floor(w << shift / q)`` by a chunked long division (every
        intermediate below 2**63)."""
        quot = torch.zeros_like(w)
        rem = w.clone()
        shift = self.shoup_shift
        while shift > 0:
            step = min(13, shift)
            shift -= step
            rem = rem << step
            quot = (quot << step) + rem // self.q
            rem = rem % self.q
        return quot

    def inv(self, x: int) -> int:
        return pow(int(x), self.q - 2, self.q)

    def root_of_unity(self, order: int) -> int:
        """The primitive ``order``-th root of unity ``g**((q-1)/order)`` of
        the least generator g."""
        q = self.q
        n, factors, d = q - 1, set(), 2
        while d * d <= n:
            while n % d == 0:
                factors.add(d)
                n //= d
            d += 1
        if n > 1:
            factors.add(n)
        g = next(g for g in range(2, 10_000)
                 if all(pow(g, (q - 1) // f, q) != 1 for f in factors))
        return pow(g, (q - 1) // order, q)

    def add(self, a, b):
        s = a + b
        return s - self.q * (s >= self.q).to(_I64)

    def sub(self, a, b):
        d = a - b
        return d + self.q * (d < 0).to(_I64)

    def neg(self, a):
        return torch.where(a == 0, torch.zeros_like(a), self.q - a)

    def to_field(self, a):
        return a + self.q * (a < 0).to(_I64)

    def mul(self, a, b):
        if self.small:
            return self.reduce(a * b)
        if self.mid:
            t = (self.bits + 1) // 2
            tm = (1 << t) - 1
            a1, a0, b1, b0 = a >> t, a & tm, b >> t, b & tm
            e2t = (1 << (2 * t)) % self.q
            big = a1 * b1 * e2t + (a1 * b0 + a0 * b1) * (1 << t) + a0 * b0
            return self.reduce(big, 3 * self.bits // 2 + 4)
        l25 = (1 << 25) - 1
        a1, a0, b1, b0 = a >> 25, a & l25, b >> 25, b & l25
        hh, mm, ll = a1 * b1, a1 * b0 + a0 * b1, a0 * b0
        e50 = (1 << 50) % self.q
        mp = (hh >> 25) * e50 + mm
        lp = (hh & l25) * e50 + ll
        big = (mp >> 25) * e50 + ((mp & l25) << 25) + lp
        return self.reduce(big, 56)

    def mul_shoup(self, x, w, w_sh):
        q = self.q
        if self.small_shoup:
            t = (x * w_sh) >> self.SMALL_SHOUP_SHIFT
        else:
            l26 = (1 << 26) - 1
            x1, x0, w1, w0 = x >> 26, x & l26, w_sh >> 26, w_sh & l26
            mid = x1 * w0 + x0 * w1 + ((x0 * w0) >> 26)
            t = x1 * w1 + (mid >> 26)
        r = x * w - t * q
        return r - q * (r >= q).to(_I64)

    def reduce(self, v, bound_bits: int = 62):
        """Non-negative ``v < 2**bound_bits`` -> [0, q)."""
        q, bits = self.q, self.bits
        eps_bits = self.eps.bit_length()
        bound = bound_bits
        while True:
            nb = max(bits, (bound - bits) + eps_bits) + 1
            if nb >= bound:
                break
            v = (v >> bits) * self.eps + (v & self.mask)
            bound = nb
        v = v - q * (v >= q).to(_I64)
        return v - q * (v >= q).to(_I64)

    def mod_sum(self, x, dim: int):
        chunk = max(2, (1 << 62) // (1 << self.bits) // 2)
        x = torch.movedim(x, dim, 0)
        while x.shape[0] > 1:
            c = min(chunk, x.shape[0])
            pad = (-x.shape[0]) % c
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            x = self.reduce(x.reshape((x.shape[0] // c, c) + tuple(x.shape[1:])).sum(dim=1))
        return x[0]


class Gadget:
    """Signed approximate digits (``d * log_b < bits``) or exact unsigned
    ones, LSB first, with ``h_j`` as the reference ``SignedBasis``."""

    def __init__(self, field: Field, log_b: int, d: int):
        self.field, self.log_b, self.d = field, log_b, d
        q, qbits = field.q, field.bits
        self.exact = d * log_b >= qbits
        if self.exact:
            self.h = [(1 << (log_b * j)) % q for j in range(d)]
            self.shift = 0
        else:
            self.shift = qbits - d * log_b
            self.h = [((q << (log_b * j)) + (1 << (d * log_b - 1))) >> (d * log_b)
                      for j in range(d)]
        self.corr_pre = max(0, qbits + field.eps.bit_length() - 62)
        self.corr_post = qbits - self.corr_pre

    def digits(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Digits of x in [0, q) stacked along ``dim``, mapped into [0, q)."""
        log_b, bmask = self.log_b, (1 << self.log_b) - 1
        if self.exact:
            return torch.stack([(x >> (log_b * j)) & bmask for j in range(self.d)], dim=dim)
        corr = ((x >> self.corr_pre) * self.field.eps) >> self.corr_post
        r = (x + corr + (1 << (self.shift - 1))) >> self.shift
        half_b, digs = 1 << (log_b - 1), []
        for _ in range(self.d):
            dj = r & bmask
            r = r >> log_b
            carry = (dj >= half_b).to(_I64)
            digs.append(dj - (carry << log_b))
            r = r + carry
        return self.field.to_field(torch.stack(digs, dim=dim))


# -------------------------------------------------------------------- NTT
def _bit_reverse(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _small_field_radices(n: int) -> list[int]:
    out = []
    while n > 16:
        out.append(8)
        n //= 8
    out.append(n)
    return out


def _mixed_orders(q: int, n: int, psi: int, radices) -> np.ndarray:
    """Exponents of psi at the output slots of the forward mixed-radix plan
    with these radices (the image of the monomial X, level by level, in
    exact host integers): (32, N/32) is the slot order of the reference TPU
    transforms at N >= 1024, and radices of 8 the small test rings'."""
    omega = psi * psi % q
    levels = len(radices)
    s = [1] * levels
    for lv in range(levels - 2, -1, -1):
        s[lv] = s[lv + 1] * radices[lv + 1]
    x = np.zeros(n, dtype=object)
    x[1] = 1
    pre = 1
    for lv, r in enumerate(radices):
        wc = pow(omega, pre, q)
        w_l = pow(wc, s[lv], q)
        mat = np.empty((r, r), dtype=object)
        for k in range(r):
            for i in range(r):
                mat[k, i] = pow(w_l, (k * i) % r, q) * pow(psi, i * s[lv], q) % q
        y = np.matmul(mat, x.reshape(pre, r, s[lv])) % q
        if s[lv] > 1:
            tw = np.array([[pow(wc, k * j, q) for j in range(s[lv])] for k in range(r)],
                          dtype=object)
            y = (y * tw[None, :, :]) % q
        x = y.reshape(n)
        pre *= r
    dlog, acc = {}, 1
    for e in range(2 * n):
        dlog[acc] = e
        acc = acc * psi % q
    return np.array([dlog[int(v)] for v in x], dtype=np.int64)


class Ntt:
    """Negacyclic NTT over Z_q[X]/(X^N + 1) along axis 0: radix-2
    Cooley-Tukey forward and Gentleman-Sande inverse, permuted into the
    reference slot order."""

    def __init__(self, field: Field, n: int, device):
        self.field, self.n = field, n
        q = field.q
        psi = field.root_of_unity(2 * n)
        psi_inv = field.inv(psi)
        self.n_inv = field.inv(n)
        br = _bit_reverse(n)
        pw, ipw = [1] * n, [1] * n
        for i in range(1, n):
            pw[i] = pw[i - 1] * psi % q
            ipw[i] = ipw[i - 1] * psi_inv % q
        fwd_tw = np.array([pw[int(b)] for b in br], dtype=np.int64)
        inv_tw = np.array([ipw[int(b)] for b in br], dtype=np.int64)
        inv_tw[1] = int(inv_tw[1]) * self.n_inv % q
        pow2n = np.empty(2 * n, dtype=np.int64)
        acc = 1
        for i in range(2 * n):
            pow2n[i] = acc
            acc = acc * psi % q

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        self.fwd_tw, self.inv_tw = dev(fwd_tw), dev(inv_tw)
        self.fwd_tw_sh, self.inv_tw_sh = field.shoup(self.fwd_tw), field.shoup(self.inv_tw)
        self.n_inv_sh = int(field.shoup(torch.tensor(self.n_inv)))
        self.mono = dev((pow2n - 1) % q)
        cpu_tw = torch.as_tensor(fwd_tw)
        delta = torch.zeros(n, 1, dtype=_I64)
        delta[1, 0] = 1
        root_of_slot = self._fwd_base(delta, cpu_tw, field.shoup(cpu_tw))[:, 0].numpy()
        dlog = {int(pow2n[i]): i for i in range(2 * n)}
        base = np.array([dlog[int(r)] for r in root_of_slot], dtype=np.int64)
        if n >= 1024 and n % 32 == 0 and (field.bits <= 27 or field.bits == 50):
            orders = _mixed_orders(q, n, psi, [32, n // 32])
        elif 2 * field.bits + 4 <= 62 and n >= 32:
            orders = _mixed_orders(q, n, psi, _small_field_radices(n))
        else:
            orders = base
        base_pos = {int(o): i for i, o in enumerate(base)}
        perm = np.array([base_pos[int(o)] for o in orders], dtype=np.int64)
        self.perm, self.perm_inv = dev(perm), dev(np.argsort(perm))
        self.orders = dev(orders)

    def _fwd_base(self, x, tw, tw_sh):
        f, n = self.field, self.n
        batch = tuple(x.shape[1:])
        ones = (1,) * len(batch)
        m, t = 1, n
        while m < n:
            t //= 2
            xr = x.reshape((m, 2, t) + batch)
            u = xr[:, 0]
            v = f.mul_shoup(xr[:, 1], tw[m:2 * m].reshape((m, 1) + ones),
                            tw_sh[m:2 * m].reshape((m, 1) + ones))
            x = torch.stack((f.add(u, v), f.sub(u, v)), dim=1).reshape((n,) + batch)
            m *= 2
        return x

    def fwd(self, x):
        return self._fwd_base(x, self.fwd_tw, self.fwd_tw_sh)[self.perm]

    def inv(self, x):
        f, n = self.field, self.n
        x = x[self.perm_inv]
        batch = tuple(x.shape[1:])
        ones = (1,) * len(batch)
        t, h = 1, n // 2
        while h >= 1:
            xr = x.reshape((h, 2, t) + batch)
            u, v = xr[:, 0], xr[:, 1]
            s = f.add(u, v)
            if h == 1:
                s = f.mul_shoup(s, self.n_inv, self.n_inv_sh)
            x = torch.stack((s, f.mul_shoup(f.sub(u, v), self.inv_tw[h:2 * h].reshape((h, 1) + ones),
                                            self.inv_tw_sh[h:2 * h].reshape((h, 1) + ones))),
                            dim=1).reshape((n,) + batch)
            t *= 2
            h //= 2
        return x

    def fwd_last(self, x):
        return torch.movedim(self.fwd(torch.movedim(x, -1, 0)), 0, -1)

    def inv_last(self, x):
        return torch.movedim(self.inv(torch.movedim(x, -1, 0)), 0, -1)

    def monomial_minus_one(self, a):
        """NTT(X^a - 1), (N,) + a.shape."""
        idx = (self.orders.reshape((self.n,) + (1,) * a.dim()) * a[None]) % (2 * self.n)
        return self.mono[idx]


# --------------------------------------------------------------- parameters
class Params:
    """One configuration file's cryptographic and layout numbers."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    n0 = property(lambda s: s.cfg["clue"]["dimension"])
    q0 = property(lambda s: s.cfg["clue"]["cipher_modulus"])
    n1 = property(lambda s: s.cfg["first_level_br"]["dimension"])
    q1 = property(lambda s: s.cfg["first_level_br"]["modulus"])
    n2 = property(lambda s: s.cfg["second_level_br"]["dimension"])
    q2 = property(lambda s: s.cfg["second_level_br"]["modulus"])
    n_int = property(lambda s: s.cfg["intermediate_lwe"]["dimension"])
    q_int = property(lambda s: s.cfg["intermediate_lwe"]["cipher_modulus"])


class Layout:
    """The digest layout of a board (reference ``retrieval_params.rs``)."""

    def __init__(self, params: Params, total: int, pertinent: int):
        c = params.cfg
        self.p = c["output_plain_modulus"]
        self.n = params.n2
        self.total, self.pertinent = total, pertinent
        self.buckets = c["bucket_count_per_segment"]
        self.segment_count = c["segment_count"]
        self.per_cipher = c["cmb_count_per_cipher"]
        self.plen = c["payload_length"]
        p = self.p
        if p & (p - 1) == 0:
            self.digits = -(-max(1, (max(total, 2) - 1).bit_length()) // (p.bit_length() - 1))
            self.combinations = pertinent + 10
        else:
            self.digits = 1
            while p ** self.digits < total:
                self.digits += 1
            self.combinations = pertinent + 5
        self.spb = self.digits + 1
        self.sps = self.spb * self.buckets
        self.segs = self.n // self.sps
        self.index_cts = self.segment_count // self.segs
        self.payload_cts = -(-self.combinations // self.per_cipher)


# ------------------------------------------------------------------ the keys
def _pair_bits(sk: torch.Tensor) -> torch.Tensor:
    s0, s1 = sk[0::2], sk[1::2]
    return torch.stack([s0 * (1 - s1), s1 * (1 - s0), s0 * s1], dim=1).reshape(-1)


def _negacyclic(poly: torch.Tensor, q: int) -> torch.Tensor:
    """M[i, k] = coefficient k of X^i * poly mod (X^n + 1, q)."""
    n = poly.shape[0]
    i = torch.arange(n, device=poly.device)[:, None]
    k = torch.arange(n, device=poly.device)[None, :]
    src = poly[(k - i) % n]
    return torch.where(k >= i, src, (q - src) % q)


def _gaussian(gen, shape, sigma, q):
    if sigma == 0.0:
        return torch.zeros(shape, dtype=_I64, device=gen.device)
    e = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float64)
    return torch.remainder(torch.round(e * sigma).to(_I64), q)


def _uniform(gen, shape, q):
    return torch.randint(0, q, shape, generator=gen, device=gen.device, dtype=_I64)


class Omr:
    """Contexts, keys and the plain computation of one configuration on
    one device. ``seed`` makes the recipient's secrets and every key's
    randomness with one ``torch.Generator`` on ``device``."""

    def __init__(self, params: Params, device, seed: int):
        self.params, self.device = params, torch.device(device)
        c = params.cfg
        self.f1, self.f2 = Field(params.q1), Field(params.q2)
        self.ntt1 = Ntt(self.f1, params.n1, self.device)
        self.ntt2 = Ntt(self.f2, params.n2, self.device)
        br1, br2, tr = c["first_level_br"], c["second_level_br"], c["trace"]
        self.g1 = Gadget(self.f1, br1["log_basis"], br1["basis_len"])
        self.g2 = Gadget(self.f2, br2["log_basis"], br2["basis_len"])
        self.gt = Gadget(self.f2, tr["log_basis"], tr["basis_len"])
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.luts()
        self.secrets()

    # ------------------------------------------------------------ set-up
    def luts(self):
        p, c = self.params, self.params.cfg

        def negacyclic_lut(values, n, log_t):
            half, seq = n >> log_t, []
            tail = values[1:]
            for i in range(max(len(values), len(tail)) * 2):
                src = values if i % 2 == 0 else tail
                if i // 2 < len(src):
                    seq.append(src[i // 2])
            lut = np.zeros(n, dtype=np.int64)
            for k, v in enumerate(seq[:1 << log_t]):
                lut[k * half:(k + 1) * half] = v
            return lut

        q1, t_in = p.q1, c["clue"]["plain_modulus"]
        t_out = c["intermediate_lwe"]["plain_modulus"]
        one = ((q1 >> (t_out.bit_length() - 2)) + 1) >> 1
        lut1 = negacyclic_lut([one, 0, 0, 0, q1 - one], p.n1, t_in.bit_length() - 1)
        q2, pp = p.q2, c["output_plain_modulus"]
        one2 = ((q2 >> (pp.bit_length() - 2)) + 1) >> 1 if pp & (pp - 1) == 0 else (2 * q2 + pp) // (2 * pp)
        data = [0] * t_out
        data[c["clue_count"] * 2] = one2
        lut2 = negacyclic_lut(data, p.n2, t_out.bit_length() - 1)
        dev = self.device
        self.lut1 = torch.as_tensor(np.concatenate([lut1, (q1 - lut1) % q1]), device=dev)
        self.lut2 = torch.as_tensor(np.concatenate([lut2, (q2 - lut2) % q2]), device=dev)
        n, cc = p.n0, c["clue_count"]
        i, j = np.arange(cc)[:, None], np.arange(n)[None, :]
        self.ex_idx = torch.as_tensor(np.where(j <= i, i - j, n + i - j), device=dev)
        self.ex_neg = torch.as_tensor(j > i, device=dev).expand(cc, n)
        autos = []
        n2, r = p.n2, p.n2
        while r >= 2:
            pos = ((r + 1) * np.arange(n2, dtype=np.int64)) % (2 * n2)
            dest = np.where(pos < n2, pos, pos - n2)
            gidx, gsign = np.zeros(n2, dtype=np.int64), np.zeros(n2, dtype=np.int64)
            gidx[dest] = np.arange(n2)
            gsign[dest] = np.where(pos < n2, 1, -1)
            autos.append((torch.as_tensor(gidx, device=dev), torch.as_tensor(gsign, device=dev)))
            r //= 2
        self.autos = autos

    def _secret(self, kind: str, n: int) -> torch.Tensor:
        lo = 0 if kind == "binary" else -1
        return torch.randint(lo, 2, (n,), generator=self.gen, device=self.device, dtype=_I64)

    def secrets(self):
        c = self.params.cfg
        self.clue_sk = self._secret(c["clue"]["secret_type"], self.params.n0)
        self.inter_sk = self._secret(c["intermediate_lwe"]["secret_type"], self.params.n_int)
        self.z1 = self._secret(c["first_level_br"]["secret_type"], self.params.n1)
        self.z2 = self._secret(c["second_level_br"]["secret_type"], self.params.n2)
        self.z1_f = self.f1.to_field(self.z1)
        self.z2_f = self.f2.to_field(self.z2)
        self.z1_ntt = self.ntt1.fwd_last(self.z1_f)
        self.z2_ntt = self.ntt2.fwd_last(self.z2_f)

    def _bsk(self, msgs, z_f, z_ntt, f: Field, ntt: Ntt, g: Gadget, sigma):
        """RGSW encryptions of the pair messages, layout (n, N, d, c, o)."""
        q, n, d, big_n = f.q, msgs.shape[0], g.d, ntt.n
        shape = (n, 2, d, big_n)
        a = _uniform(self.gen, shape, q)
        e = _gaussian(self.gen, shape, float(sigma), q)
        h = torch.as_tensor(g.h, dtype=_I64, device=self.device)
        hs = (h[None, :] * msgs[:, None]) % q
        mu_c0 = f.mul(((q - hs) % q)[:, :, None], z_f[None, None, :])
        mu_c1 = torch.zeros_like(mu_c0)
        mu_c1[:, :, 0] = hs
        payload = ntt.fwd_last(f.add(torch.stack([mu_c0, mu_c1], dim=1), e))
        b = f.add(f.mul(a, z_ntt), payload)
        return torch.stack([a, b], dim=-1).permute(0, 3, 2, 1, 4).contiguous()

    def detection_key(self) -> dict:
        """BSK1, KSK, BSK2 and the trace key with Shoup companions, in the
        reference layouts and slot orders."""
        c, p = self.params.cfg, self.params
        bsk1 = self._bsk(_pair_bits(self.clue_sk), self.z1_f, self.z1_ntt, self.f1, self.ntt1,
                         self.g1, c["first_level_br"]["noise_std"])
        ks = c["first_level_ks"]
        n_in, n_out, digits, q = ks["in_dimension"], ks["out_dimension"], -(-ks["log_modulus"] // ks["log_basis"]), p.q1
        a = _uniform(self.gen, (n_in, digits, n_out), q)
        e = _gaussian(self.gen, (n_in, digits), float(ks["noise_std"]), q)
        h = torch.tensor([(1 << j) % q for j in range(digits)], dtype=_I64, device=self.device)
        asum = (a * self.inter_sk).sum(-1) % q
        b = (asum + e + (h[None, :] * self.z1_f[:, None]) % q) % q
        ksk = torch.cat([a.transpose(0, 1).reshape(digits * n_in, n_out),
                         b.T.reshape(digits * n_in, 1)], dim=1).contiguous()
        del a
        bsk2 = self._bsk(_pair_bits(self.inter_sk), self.z2_f, self.z2_ntt, self.f2, self.ntt2,
                         self.g2, c["second_level_br"]["noise_std"])
        f = self.f2
        sig = torch.stack([f.to_field(gs * self.z2_f[gi]) for gi, gs in self.autos])
        ht = torch.as_tensor(self.gt.h, dtype=_I64, device=self.device)
        shape = (sig.shape[0], self.gt.d, p.n2)
        ta = _uniform(self.gen, shape, f.q)
        te = _gaussian(self.gen, shape, float(c["trace"]["noise_std"]), f.q)
        payload = self.ntt2.fwd_last(f.add(f.mul(ht[None, :, None], sig[:, None, :]), te))
        tk = torch.stack([ta, f.add(f.mul(ta, self.z2_ntt), payload)], dim=-1)
        trace_k = tk.permute(0, 2, 1, 3).contiguous()
        return {"bsk1": bsk1, "bsk1_sh": self.f1.shoup(bsk1), "ksk": ksk,
                "bsk2": bsk2, "bsk2_sh": self.f2.shoup(bsk2),
                "trace_k": trace_k, "trace_k_sh": self.f2.shoup(trace_k)}

    def clue_key(self, clue_sk: torch.Tensor) -> torch.Tensor:
        """(n0, n0 + clue_count) columns a | b7 of the public key in RLWE
        mode under ``clue_sk``."""
        c = self.params.cfg["clue"]
        n, q0 = c["dimension"], c["cipher_modulus"]
        pk_a = _uniform(self.gen, (n,), q0)
        e = torch.round(torch.randn((n,), generator=self.gen, device=self.device,
                                    dtype=torch.float64) * c["noise_std"]).to(_I64)
        conv = _negacyclic(pk_a, q0)
        pk_b = ((clue_sk[:, None] * conv).sum(0) + e) % q0
        b7 = _negacyclic(pk_b, q0)[:, :self.params.cfg["clue_count"]]
        return torch.cat([conv, b7], dim=1).to(torch.float64)

    def other_clue_sk(self) -> torch.Tensor:
        """Another recipient's clue secret: the senders of the messages that
        are not this recipient's encrypt under it."""
        return self._secret(self.params.cfg["clue"]["secret_type"], self.params.n0)

    def clues(self, mat: torch.Tensor, count: int) -> torch.Tensor:
        """``count`` clues (count, n0 + clue_count) under the public key
        ``mat``: u * pk + e mod q0 with binary u (the float64 product of
        0/1 rows and entries below 2**11 is exact)."""
        c = self.params.cfg["clue"]
        u = torch.randint(0, 2, (count, mat.shape[0]), generator=self.gen, device=self.device,
                          dtype=torch.float64)
        e = torch.randn((count, mat.shape[1]), generator=self.gen, device=self.device,
                        dtype=torch.float64)
        r = torch.matmul(u, mat).to(_I64) + torch.round(e * c["noise_std"]).to(_I64)
        return r & (c["cipher_modulus"] - 1)

    def decrypt_clue(self, row: torch.Tensor) -> torch.Tensor:
        """The clue_count plaintexts of one clue under this recipient's
        clue secret; a message is this recipient's iff all are 0."""
        c = self.params.cfg["clue"]
        n, q0, t = c["dimension"], c["cipher_modulus"], c["plain_modulus"]
        a, b7 = row[:n], row[n:]
        a_ext = torch.where(self.ex_neg, (q0 - a[self.ex_idx]) % q0, a[self.ex_idx])
        phase = (b7 - (a_ext * self.clue_sk).sum(-1)) % q0
        return ((phase * t * 2 + q0) // (2 * q0)) % t

    # ------------------------------------------------------------- detect
    def _blind_rotate(self, acc, amounts, bsk, bsk_sh, f: Field, ntt: Ntt, g: Gadget):
        """Paired CMUX chain: acc (N, 2, B), amounts (n_lwe, B)."""
        two_n = 2 * ntt.n
        a0, a1 = amounts[0::2], amounts[1::2]
        rot = torch.stack([a0, a1, (a0 + a1) % two_n], dim=1)
        for i in range(amounts.shape[0] // 2):
            dn = ntt.fwd(g.digits(acc, dim=1))  # (N, d, 2, B)
            prod = f.mul_shoup(dn[None, :, :, :, None, :], bsk[3 * i:3 * i + 3][..., None],
                               bsk_sh[3 * i:3 * i + 3][..., None])
            p = f.reduce(prod.sum(dim=(2, 3)), f.bits + (2 * g.d).bit_length() + 1)
            p = f.mul(p, ntt.monomial_minus_one(rot[i]).transpose(0, 1)[:, :, None, :])
            acc = f.add(acc, ntt.inv(f.mod_sum(p, dim=0)))
        return acc

    def _init_acc(self, lut, b, n):
        ks = torch.arange(n, dtype=_I64, device=b.device)[:, None]
        acc_b = lut[(ks + b[None, :]) % (2 * n)]
        return torch.stack([torch.zeros_like(acc_b), acc_b], dim=1)

    def detect(self, clues: torch.Tensor, key: dict, ks_dtype=torch.float64) -> torch.Tensor:
        """Pertinency ciphertexts (B, 2, N2), NTT domain, reference slot
        order, of clues (B, n0 + clue_count)."""
        p, c = self.params, self.params.cfg
        f1, f2 = self.f1, self.f2
        n0, cc, q0, n1 = p.n0, c["clue_count"], p.q0, p.n1
        bsz = clues.shape[0]
        a, b7 = clues[:, :n0], clues[:, n0:]
        vals = a[:, self.ex_idx]
        a_ext = torch.where(self.ex_neg, (q0 - vals) % q0, vals)
        amounts = a_ext.reshape(bsz * cc, n0).T.contiguous()
        acc = self._init_acc(self.lut1, b7.reshape(bsz * cc), n1)
        acc = self._blind_rotate(acc, amounts, key["bsk1"], key["bsk1_sh"], f1, self.ntt1, self.g1)
        acc = f1.mod_sum(acc.permute(2, 1, 0).reshape(bsz, cc, 2, n1), dim=1).permute(2, 1, 0)
        a1 = acc[:, 0, :]
        a_perm = torch.cat([a1[0:1], torch.flip(a1[1:], dims=(0,))], dim=0)
        a_vec = torch.cat([a_perm[0:1], f1.neg(a_perm[1:])], dim=0).T  # (B, N1)
        ks = c["first_level_ks"]
        digits, n_out = -(-ks["log_modulus"] // ks["log_basis"]), ks["out_dimension"]
        shifts = torch.arange(digits, dtype=_I64, device=clues.device)
        bits = ((a_vec[:, None, :] >> shifts[None, :, None]) & 1).reshape(bsz, -1)
        s = torch.matmul(bits.to(ks_dtype), key["ksk"].to(ks_dtype)).to(_I64)
        s = f1.reduce(s, (digits * n1 * f1.q).bit_length() + 1)
        ks_a, ks_b = f1.neg(s[:, :n_out]), f1.sub(acc[0, 1, :], s[:, n_out])
        q_int = p.q_int
        ms_a = ((ks_a * (2 * q_int) + f1.q) // (2 * f1.q)) & (q_int - 1)
        ms_b = ((ks_b * (2 * q_int) + f1.q) // (2 * f1.q)) & (q_int - 1)
        offset = cc * (q_int // c["intermediate_lwe"]["plain_modulus"])
        ms_b = (ms_b + offset) & (q_int - 1)
        acc2 = self._init_acc(self.lut2, ms_b, p.n2)
        acc2 = self._blind_rotate(acc2, ms_a.T.contiguous(), key["bsk2"], key["bsk2_sh"], f2,
                                  self.ntt2, self.g2)
        n_inv = f2.inv(p.n2)
        acc2 = f2.mul_shoup(acc2, n_inv, int(f2.shoup(torch.tensor(n_inv))))
        acc2 = self._trace(acc2, key["trace_k"], key["trace_k_sh"])
        return self.ntt2.fwd(acc2).permute(2, 1, 0).contiguous()

    def _trace(self, acc, trace_k, trace_k_sh):
        f, ntt, g = self.f2, self.ntt2, self.gt
        for r, (gi, gs) in enumerate(self.autos):
            auto = f.to_field(gs[:, None, None] * acc[gi])
            dn = ntt.fwd(g.digits(auto[:, 0, :], dim=1))
            prod = f.mul_shoup(dn[:, :, None, :], trace_k[r][..., None], trace_k_sh[r][..., None])
            pc = ntt.inv(f.reduce(prod.sum(dim=1), f.bits + g.d.bit_length() + 1))
            acc = f.add(acc, torch.stack([f.neg(pc[:, 0, :]), f.sub(auto[:, 1, :], pc[:, 1, :])],
                                         dim=1))
        return acc

    # ------------------------------------------------------- digest encoders
    def _centre(self, v, p):
        return torch.where(v < (p + 1) >> 1, v, self.f2.q - p + v)

    def _encode(self, pert, polys):
        """sum over messages of pert * NTT(poly) mod q2: pert (B, 2, N2),
        polys (B, N2) -> (2, N2)."""
        f = self.f2
        return f.mod_sum(f.mul(pert, self.ntt2.fwd_last(polys)[:, None, :]), dim=0)

    def index_digest(self, lay: Layout, pert, base_addr: torch.Tensor, chunk: int = 2048):
        """One index-digest ciphertext of the stack ``pert`` (D, 2, N2);
        ``base_addr`` (D, segs) each message's bucket per segment."""
        f, p = self.f2, lay.p
        out = torch.zeros((2, lay.n), dtype=_I64, device=self.device)
        for s in range(0, pert.shape[0], chunk):
            e = min(s + chunk, pert.shape[0])
            addr = base_addr[s:e].to(self.device)
            v = torch.arange(s, e, dtype=_I64, device=self.device)
            poly = torch.zeros((e - s, lay.n), dtype=_I64, device=self.device)
            for k in range(lay.digits + 1):
                val = self._centre(v % p, p) if k < lay.digits else torch.ones_like(v)
                v = v // p
                poly.scatter_(1, addr + k, val[:, None].expand(-1, addr.shape[1]))
            out = f.add(out, self._encode(pert[s:e].to(self.device), poly))
        return out

    def payload_digests(self, lay: Layout, pert, payloads: torch.Tensor, weights: torch.Tensor,
                        chunk: int = 2048):
        """The combination ciphertexts (payload_cts, 2, N2); ``weights``
        (payload_cts, per_cipher, D)."""
        f, p, plen = self.f2, lay.p, lay.plen
        out = torch.zeros((lay.payload_cts, 2, lay.n), dtype=_I64, device=self.device)
        for s in range(0, pert.shape[0], chunk):
            e = min(s + chunk, pert.shape[0])
            part = pert[s:e].to(self.device)
            pay = payloads[s:e].to(self.device)
            for k in range(lay.payload_cts):
                w = weights[k, :, s:e].to(self.device)
                wp = (pay[None, :, :] * w[:, :, None]) % p  # (per, B, plen)
                poly = torch.zeros((e - s, lay.n), dtype=_I64, device=self.device)
                poly[:, :w.shape[0] * plen] = self._centre(wp, p).permute(1, 0, 2).reshape(e - s, -1)
                out[k] = f.add(out[k], self._encode(part, poly))
        return out


def bucket_draws(lay: Layout, rng: np.random.Generator) -> np.ndarray:
    """One index digest's bucket draws, (D, segs) first slots, in one
    ``rng.integers`` call (reference ``detector.rs:271-323``)."""
    buckets = rng.integers(0, lay.buckets, size=(lay.total, lay.segs), dtype=np.int64)
    return np.arange(lay.segs, dtype=np.int64)[None, :] * lay.sps + buckets * lay.spb


def payload_weights(lay: Layout, seed: int) -> np.ndarray:
    """The shared weight stream (payload_cts, per_cipher, D): rows past
    the combinations are 0 (reference ``detector.rs:376-389``)."""
    rng = np.random.default_rng(seed)
    w = np.zeros((lay.payload_cts * lay.per_cipher, lay.total), dtype=np.int64)
    w[:lay.combinations] = rng.integers(0, lay.p, size=(lay.combinations, lay.total),
                                        dtype=np.int64)
    return w.reshape(lay.payload_cts, lay.per_cipher, lay.total)
