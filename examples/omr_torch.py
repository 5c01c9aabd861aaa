"""End-to-end OMR run on the PyTorch / CUDA port: keygen -> clues -> detect
-> digests -> decode -> verify.

The counterpart of examples/omr.py for ``tfhe_omr_tpu_torch`` (reference
``omr_core/examples/omr.rs``). Every step runs on ``--device``: key
generation, clue generation (unless ``--host-clues``), detection into one
preallocated (D, 2, N2) pertinency stack, both digest encoders and the
recipient's decrypts. The decode's bucket scan and linear solve run in the
native C++ library on the host.

``--sharded`` splits every detect batch and both digest encoders over all
visible cards (``--devices N`` takes the first N; with ``--device cpu`` it
makes N CPU replicas), with the digests' exact modular reduce. To run one
process per card or per host, start the SAME command on every rank with
``--coordinator host0:port --num-processes N --process-id i`` (or under
``torchrun`` with ``--distributed``, which reads the environment). That
implies ``--sharded`` and ``--host-clues``, needs ``--seed`` (every rank
derives the same keys and clues), dispatches the whole board at once
(``--batch`` is ignored) and lets only rank 0 write ``--csv`` / ``--json``.

Verification (``omr.py``'s, after ``omr_time_analyze.rs:215-235``): the true
indices are a subset of the decoded ones, every decoded payload equals its
board payload byte for byte, and every extra index is confirmed as a
protocol false positive (all its clues decrypt to 0 under the recipient's
key). The exit code is 0 only then.

Usage:
    python examples/omr_torch.py -p 65536 --batch 1024 --json out.json  # on the card
    python examples/omr_torch.py --tiny -p 16 --device cpu              # plain torch
    python examples/omr_torch.py -p 65536 --sharded                     # every card
    python examples/omr_torch.py -p 2048 --seed 1 --coordinator 127.0.0.1:29500 \
        --num-processes 2 --process-id 0     # and the same with --process-id 1

The card is the default; with no card and no ``--device cpu`` the script
exits non-zero and says so.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger("omr_torch")


@dataclass
class OmrKeys:
    """The recipient's pack, a second pack for the other messages' clues,
    both senders and the detector."""

    skp: object
    skp2: object
    sender: object
    sender2: object
    detector: object


@dataclass
class OmrRun:
    """What one board produced: the verification, the stage seconds
    (``rec``) and the kernel launches of each stage."""

    rec: object  # TimingRecord
    true_indices: list
    indices: list
    extras: list
    fp_events: list
    subset_ok: bool
    payload_ok: bool
    fp_all_confirmed: bool
    launches: dict = field(default_factory=dict)  # stage -> {kernel: count}
    # kept for checks against the plain path
    retriever: object = None
    pertinency: object = None  # (D, 2, N2) tensor on the device
    payloads: np.ndarray = None
    digest_seed: int = 0
    index_cts: list = None
    payload_cts: object = None

    @property
    def ok(self) -> bool:
        return self.subset_ok and self.payload_ok and self.fp_all_confirmed


class _Stages:
    """Synchronised wall seconds and kernel launches per stage."""

    def __init__(self, sync):
        from tfhe_omr_tpu_torch.utils import build

        self._launches = build.LAUNCHES
        self._sync = sync
        self.seconds: dict[str, float] = {}
        self.launches: dict[str, dict[str, int]] = {}

    def run(self, name, fn, *args, **kwargs):
        before = Counter(self._launches)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._sync()
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = dict(Counter(self._launches) - before)
        return out


def make_keys(params, seed=None, device=None) -> OmrKeys:
    """Two recipients' packs (numpy seeds ``seed`` and ``seed + 1``, fresh
    entropy when ``seed`` is None), their senders and the first one's
    detector, all on ``device`` (the card unless ``device="cpu"``; with no
    card it raises)."""
    from tfhe_omr_tpu_torch.core.context import OmrContext
    from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack

    ctx = OmrContext(params, device)
    skp = SecretKeyPack(params, rng=seed, ctx=ctx)
    skp2 = SecretKeyPack(params, rng=None if seed is None else seed + 1, ctx=ctx)
    return OmrKeys(skp, skp2, skp.generate_sender(), skp2.generate_sender(),
                   skp.generate_detector())


def run_board(keys: OmrKeys, all_count: int, pertinent_count: int,
              rng: np.random.Generator, batch: int = 1024,
              host_clues: bool = False, runner=None,
              profile_dir: str | None = None) -> OmrRun:
    """One board of ``all_count`` messages, ``pertinent_count`` of them the
    recipient's: clues, detect, digests, decode and verification.

    ``runner`` drives detect and both digest encoders: the pack's
    ``Detector`` unless a ``ShardedDetector`` is given, whose digests then go
    through the sharded reduce end to end; the stack then stays sharded,
    each shard's rows on its own device (``RankRows``), in one process as
    across ranks.
    ``profile_dir`` takes a ``torch.profiler`` Chrome trace of the detect
    stage."""
    import torch

    from tfhe_omr_tpu_torch.core.payload import random_payloads
    from tfhe_omr_tpu_torch.core.sender import ClueBatch
    from tfhe_omr_tpu_torch.utils.timing import TimingRecord, synchronize

    skp, detector = keys.skp, keys.detector
    params = skp.params
    dev = detector.device
    if runner is None:
        runner = detector
    sharded = hasattr(runner, "mesh")
    st = _Stages(getattr(runner, "synchronize", lambda: synchronize(dev)))
    rec = TimingRecord(device_count=getattr(runner, "n_dev", 1),
                       payload_count=all_count)

    pertinent = np.zeros(all_count, dtype=bool)
    pertinent[:pertinent_count] = True
    rng.shuffle(pertinent)
    true_indices = sorted(np.nonzero(pertinent)[0].tolist())
    n_dim = params.clue_params.dimension
    n_pert = int(pertinent.sum())

    def gen_clues():
        if host_clues:
            own = keys.sender.gen_clues(n_pert, rng)
            other = keys.sender2.gen_clues(all_count - n_pert, rng)
            buf = np.zeros((all_count, n_dim + params.clue_count), dtype=np.int64)
            buf[pertinent] = np.concatenate([own.a, own.b7], axis=1)
            buf[~pertinent] = np.concatenate([other.a, other.b7], axis=1)
            return torch.as_tensor(buf, device=dev)
        own_d = keys.sender.gen_clues_device_resident(
            n_pert, int(rng.integers(1 << 62)))
        other_d = keys.sender2.gen_clues_device_resident(
            all_count - n_pert, int(rng.integers(1 << 62)))
        perm = np.zeros(all_count, dtype=np.int64)
        perm[pertinent] = np.arange(n_pert)
        perm[~pertinent] = n_pert + np.arange(all_count - n_pert)
        return torch.cat([own_d, other_d])[torch.as_tensor(perm, device=dev)]

    clue_buf = st.run("gen_clues", gen_clues)  # (D, n0 + clue_count) on dev
    t0 = time.perf_counter()
    payloads = random_payloads(rng, all_count, params.payload_length)
    rec.gen_payloads_time = time.perf_counter() - t0

    def detect():
        if sharded:  # each replica detects its own rows and keeps them
            return runner.detect(ClueBatch(clue_buf[:, :n_dim], clue_buf[:, n_dim:]),
                                 batch)
        pv = torch.empty((all_count, 2, params.n2), dtype=torch.int64, device=dev)
        for s in range(0, all_count, batch):
            e = min(s + batch, all_count)
            pv[s:e] = runner.detect(
                ClueBatch(clue_buf[s:e, :n_dim], clue_buf[s:e, n_dim:]))
            log.info("  detected %d/%d", e, all_count)
        return pv

    # what a first detect and a first encoder chunk pay once (the kernel
    # library, first launches, the allocator), before anything is timed
    t0 = time.perf_counter()
    warm = runner.warm(min(all_count, batch * getattr(runner, "n_dev", 1)))
    log.info("warm detect (%.3fs): %s", time.perf_counter() - t0, warm)

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            pv = st.run("detect", detect)
        os.makedirs(profile_dir, exist_ok=True)
        rank = getattr(getattr(runner, "mesh", None), "rank", 0)
        trace_path = os.path.join(profile_dir, f"detect_trace_rank{rank}.json")
        prof.export_chrome_trace(trace_path)
        log.info("profiler trace of the detect stage written to %s", trace_path)
    else:
        pv = st.run("detect", detect)
    log.info("detect: %.3fs (%.1f msg/s)", st.seconds["detect"],
             all_count / st.seconds["detect"])

    retriever = skp.generate_retriever(all_count, pertinent_count)
    rp = retriever.params
    t0 = time.perf_counter()
    warm = runner.warm_encoders(rp, all_count)
    log.info("warm encoders (%.3fs): %s", time.perf_counter() - t0, warm)
    index_cts = st.run("encode_indices", lambda: [
        runner.encode_pertinent_indices(rp, pv, rng)
        for _ in range(rp.max_encode_indices_cipher_count)])
    digest_seed = int(rng.integers(0, 2**63))
    payload_cts = st.run("encode_payloads", runner.encode_pertinent_payloads,
                         rp, pv, payloads, digest_seed)
    log.info("encode: indices %.3fs (%d cts), payloads %.3fs (%d cts)",
             st.seconds["encode_indices"], len(index_cts),
             st.seconds["encode_payloads"], payload_cts.shape[0])
    retriever.warm()
    indices, solved = st.run("decode", retriever.decode_digest, index_cts,
                             payload_cts, digest_seed)
    log.info("decode: %.3fs", st.seconds["decode"])

    rec.gen_clues_time = st.seconds["gen_clues"]
    rec.detect_time = st.seconds["detect"]
    rec.detect_time_per_message = rec.detect_time / all_count
    rec.encode_indices_time = st.seconds["encode_indices"]
    rec.encode_payloads_time = st.seconds["encode_payloads"]
    rec.decode_time = st.seconds["decode"]

    true_set, decoded_set = set(true_indices), set(indices)
    missing = [i for i in true_indices if i not in decoded_set]
    extras = [i for i in indices if i not in true_set]
    payload_ok = bool(np.array_equal(solved, payloads[indices]))
    fp_events = []
    for i in extras:
        row = clue_buf[i].cpu().numpy()
        vals = skp.decrypt_compact_clue(row[:n_dim], row[n_dim:])
        confirmed = bool((vals == 0).all())
        fp_events.append({
            "index": int(i),
            "clue_values_mod_t": [int(v) for v in vals],
            "protocol_fp_confirmed": confirmed,
        })
        (log.info if confirmed else log.error)(
            "extra index %d: clue decryptions %s -> %s", i, list(vals),
            "protocol false positive (all clues decrypt to 0)" if confirmed
            else "NOT a clue collision - framework bug",
        )
    if missing:
        log.error("missing true indices: %s (decoded %d, true %d)",
                  missing[:10], len(indices), len(true_indices))
    if not payload_ok:
        log.error("payload mismatch: %d differing bytes",
                  int((solved != payloads[indices]).sum()))
    return OmrRun(
        rec=rec, true_indices=true_indices, indices=indices, extras=extras,
        fp_events=fp_events, subset_ok=not missing, payload_ok=payload_ok,
        fp_all_confirmed=all(e["protocol_fp_confirmed"] for e in fp_events),
        launches=st.launches, retriever=retriever, pertinency=pv,
        payloads=payloads, digest_seed=digest_seed, index_cts=index_cts,
        payload_cts=payload_cts,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-p", "--payload-count", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1024,
                    help="messages per detect call")
    ap.add_argument("--tiny", action="store_true", help="the small test preset")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails when no card is present) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="numpy seed of keys, clues and digests (fresh if unset)")
    ap.add_argument("--host-clues", action="store_true",
                    help="generate clues with host numpy instead of on the device")
    ap.add_argument("--sharded", action="store_true",
                    help="shard over all visible cards (or --devices N)")
    ap.add_argument("--devices", type=int, default=None,
                    help="with --sharded: the first N cards, or N CPU replicas "
                         "with --device cpu")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the detect "
                         "stage into this directory")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group named by the environment "
                         "(RANK, WORLD_SIZE, MASTER_ADDR, as torchrun sets them)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's address host:port (manual bring-up)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--csv", default=None, help="write a timing record CSV")
    ap.add_argument("--json", default=None,
                    help="write a JSON record (stage walls + verification)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from tfhe_omr_tpu_torch.core.params import OmrParameters
    from tfhe_omr_tpu_torch.utils import build
    from tfhe_omr_tpu_torch.utils.timing import synchronize, write_csv

    from tfhe_omr_tpu_torch.parallel import distributed

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    all_count = args.payload_count
    pertinent_count = min(all_count, 8 if args.tiny else 50)
    multiproc = False
    try:
        if args.distributed or args.coordinator:
            # --device goes in as given: init picks each rank's card
            distributed.init(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
            args.sharded = True
            multiproc = distributed.is_multihost()
        if distributed.local_devices():
            device = distributed.local_devices()[0]
        else:
            device = build.resolve_device(args.device)
    except RuntimeError as err:  # no card and no --device cpu
        sys.exit(f"omr_torch: {err}")
    if multiproc:
        if args.seed is None:
            sys.exit("omr_torch: --seed is required multi-process: every "
                     "process must derive identical keys and clue streams")
        # every rank makes the same clues from the same numpy stream (the
        # device generators of different cards need not agree)
        args.host_clues = True
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log.info("device %s (%s), payloads %d, pertinent %d", device, kind,
             all_count, pertinent_count)
    if device.type == "cuda":
        t0 = time.perf_counter()
        build.library()  # nvcc, outside the timed stages
        log.info("kernels ready in %.1fs", time.perf_counter() - t0)

    total0 = time.perf_counter()
    before_keygen = Counter(build.LAUNCHES)
    keys = make_keys(params, args.seed, device)
    synchronize(device)
    keygen_launches = dict(Counter(build.LAUNCHES) - before_keygen)
    log.info("keygen: %.3fs; detection key on the device %d bytes",
             time.perf_counter() - total0, keys.detector.detect_key_size())
    runner = None
    if args.sharded:
        from tfhe_omr_tpu_torch.parallel import ShardedDetector, make_data_mesh

        if device.type == "cpu":
            devices = ["cpu"] * (args.devices or 1)
        elif distributed.local_devices():
            devices = None  # the card this rank was given
        else:
            devices = [f"cuda:{i}" for i in
                       range(args.devices or torch.cuda.device_count())]
        runner = ShardedDetector(keys.detector, make_data_mesh(devices))
        log.info("sharded over %d devices (%d local, rank %d of %d, process "
                 "group backend %s)", runner.n_dev, len(runner.replicas),
                 runner.mesh.rank, runner.mesh.world, distributed.backend())
    rng = np.random.default_rng(None if args.seed is None else args.seed + 2)
    run = run_board(keys, all_count, pertinent_count, rng, args.batch,
                    args.host_clues, runner, args.profile)
    rec = run.rec
    rec.total_time = time.perf_counter() - total0

    # digest-noise telemetry: the observed sigma of the payload digest
    # against the digit-decode margin delta/2 (no expected sigma is known
    # for these parameters, so noise_sigma_info's histogram is not shown)
    nsi = run.retriever.noise_sigma_info(run.payload_cts, 1.0)
    q2, p = params.q2, run.retriever.params.index_modulus
    margin = (2 * q2 + p) // (2 * p) / 2
    log.info("digest noise: observed sigma %.3e, decode margin %.3e (%.2f "
             "observed sigmas)", nsi["observed_sigma"], margin,
             margin / max(nsi["observed_sigma"], 1e-300))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if peak is not None:
        log.info("peak device memory: %d bytes", peak)
    if run.ok:
        log.info("all %d decoded payloads verified byte-wise (%d protocol "
                 "FPs). All done in %.1fs", len(run.indices), len(run.extras),
                 rec.total_time)

    if multiproc and runner.mesh.rank != 0:
        args.csv = args.json = None  # one writer per run
    if args.csv:
        write_csv(args.csv, [rec])
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "payload_count": all_count,
                "pertinent_count": pertinent_count,
                "byte_exact": run.payload_ok,
                "true_subset_of_decoded": run.subset_ok,
                "fp_count": len(run.extras),
                "fp_events": run.fp_events,
                "stages_s": {
                    "gen_clues": round(rec.gen_clues_time, 3),
                    "detect": round(rec.detect_time, 3),
                    "detect_ms_per_message": round(
                        1e3 * rec.detect_time_per_message, 3),
                    "encode_indices": round(rec.encode_indices_time, 3),
                    "encode_payloads": round(rec.encode_payloads_time, 3),
                    "decode": round(rec.decode_time, 3),
                    "total": round(rec.total_time, 3),
                },
                "device_count": rec.device_count,
                "process_group_backend": distributed.backend(),
                "device": kind,
                "peak_device_memory_bytes": peak,
                "kernel_launches": {"keygen": keygen_launches, **run.launches},
            }, fh, indent=1)
    distributed.shutdown()
    sys.exit(0 if run.ok else 1)


if __name__ == "__main__":
    main()
