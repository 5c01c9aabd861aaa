"""The least time an NVIDIA H100 could take for the paired blind
rotations K1 (first level) and K2 (second level), counted from the
parameters alone, whatever kernel computes them.

The least time is the larger of two bounds.

* Bytes: each input byte read once and each output byte written once
  (the accumulators in and out, the rotation amounts, the key in words of
  the field), over 3.35 TB/s.
* Operations: the modular products the algorithm needs, each valued at a
  fixed number of 32-bit integer multiply slots for its word, over 64 such
  slots a clock a streaming multiprocessor x the SMs x the top SM clock
  (``nvidia-smi clocks.max.sm``, read in the run).

Per sample and CMUX step of the paired (BMMP) chain, at ring size N, d
gadget digits (log N radix-2 stages of N/2 butterflies a transform):

* Products by a fixed operand (Shoup): the 2d forward NTTs of the digits
  of a and b, and the 2 inverse NTTs of the sum, (2d + 2) N/2 log N
  butterflies. The inverse's 1/N folds into its last stage's twiddles.
* Products summed before one reduction: the key's, 3 pair keys x 2d
  digit polynomials x 2 outputs x N slots (12 d N), and the monomials
  (X^a - 1) of the 3 pair messages on both halves (6 N).

Slots a product, by word (32-bit multiplies: a low word takes one slot,
a high word or a 64-bit product two; an operand of 64 bits is two words):

* 32-bit word (q < 2**31): a Shoup product is the low word of x w, the
  high word of x w' and the low word of t q: 4 slots; a summed product is
  one 64-bit product: 2 slots.
* 64-bit word (q < 2**63): a Shoup product is the low 64 bits of x w (one
  wide and two low products: 4 slots), the high 64 bits of x w' (four wide
  products: 8) and the low 64 bits of t q (4): 16 slots; a summed product
  is the whole 128-bit product, four wide products: 8 slots.

These are frozen: a kernel that issues more or fewer instructions, or
moves products onto another unit, does not move them. A change that moves
the products onto another unit (int8 or FP64 tensor cores) is preceded by
a benchmark change that counts them anew.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
MUL_SLOTS_PER_CLOCK_SM = 64
#: slots of a (Shoup, summed) product, by word bits
PRODUCT_SLOTS = {32: (4, 2), 64: (16, 8)}


def word_bits(q: int) -> int:
    return 32 if q.bit_length() <= 31 else 64


def cmux_products(n: int, d: int) -> tuple[int, int]:
    """(Shoup, summed) products of one sample's CMUX step."""
    log_n = n.bit_length() - 1
    return (2 * d + 2) * (n // 2) * log_n, 12 * d * n + 6 * n


def blind_rotation(n: int, d: int, q: int, steps: int, samples: int) -> dict:
    """Products, multiply slots and bytes of one paired blind rotation of
    ``samples`` accumulators over ``steps`` CMUX steps."""
    shoup, summed = cmux_products(n, d)
    per = PRODUCT_SLOTS[word_bits(q)]
    products = (shoup + summed) * steps * samples
    slots = (shoup * per[0] + summed * per[1]) * steps * samples
    word = word_bits(q) // 8
    n_bytes = (2 * samples * 2 * n * 8  # accumulators in and out, int64
               + 2 * steps * samples * 8  # rotation amounts, int64
               + 3 * steps * n * d * 2 * 2 * word)  # the key
    return {"products": products, "slots": slots, "bytes": n_bytes}


def least_seconds(work: dict, sms: int, clock_mhz: float) -> float:
    """The larger of the bytes bound and the operations bound."""
    ops = work["slots"] / (MUL_SLOTS_PER_CLOCK_SM * sms * clock_mhz * 1e6)
    return max(ops, work["bytes"] / HBM_BYTES_PER_S)


def level_work(cfg: dict, level: int, messages: int) -> dict:
    """K1 (``level`` 1: clue_count samples a message, n0 / 2 steps) or K2
    (``level`` 2: one sample a message, n_int / 2 steps) of a detect of
    ``messages`` messages at a configuration's parameters."""
    if level == 1:
        br, steps = cfg["first_level_br"], cfg["clue"]["dimension"] // 2
        samples = messages * cfg["clue_count"]
    else:
        br, steps = cfg["second_level_br"], cfg["intermediate_lwe"]["dimension"] // 2
        samples = messages
    return blind_rotation(br["dimension"], br["basis_len"], br["modulus"], steps, samples)


def kernel_share(run, level: int) -> float | None:
    """K1's (``level`` 1) or K2's share of its roofline in a traced run, in
    %: the least time of every message the window detected over the device
    time of that level's kernels (their names hold "blind_rotate" and the
    level's modulus). The work is the window's, not the launches': the
    same messages read the same share however many launches carry them.
    None where the run detected nothing or the trace holds no such kernel."""
    messages = run.record.get("messages")
    if run.trace is None or not run.clock or not messages:
        return None
    cfg = run.cell.cfg
    q = cfg["first_level_br" if level == 1 else "second_level_br"]["modulus"]
    seconds, launches = run.trace.device_seconds("blind_rotate", str(q))
    if not launches:
        return None
    least = least_seconds(level_work(cfg, level, messages), run.clock["sms"],
                          run.clock["clock_mhz"])
    return 100.0 * least / seconds
