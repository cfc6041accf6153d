"""Scaling-efficiency benchmark: distributed operators at 1..N devices.

The north-star scaling measurement (BASELINE.md: "rows/s scaling efficiency
>= 75% at 4 hosts, measured at 1 chip, 1 host, N >= 2 hosts"; SURVEY.md §7
step 7 names the 1-chip/1-host/N-host sweep as the bench suite's final
surface). The reference has no distributed layer to measure
(`SURVEY.md` §2.3); the methodology here extends its throughput formula
(`clo_sort_bench.c:233-235`) with a per-device-count sweep and an
efficiency column.

Each operator runs at every requested device count over a 1-D mesh prefix
of jax.devices(). Weak scaling (default) fixes ROWS PER DEVICE and grows
the problem with the mesh — the north star's fixed-per-host-data shape;
strong scaling fixes TOTAL rows. Efficiency is rows/s-per-device relative
to the smallest measured mesh:

    weak:   eff(k) = (rate_k / k) / (rate_b / b)      (b = smallest count)
    strong: eff(k) = (rate_k / rate_b) / (k / b)

Join and aggregate are timed through their jit-traceable `check="defer"`
path (steady-state serving form: no per-call host sync; the deferred
`dropped` counters are verified zero after the run). On a single-chip
image, run with virtual devices to validate the sweep mechanics:

  JAX_PLATFORMS=cpu python -m cl_ops_tpu.bench.scaling_bench --virtual 8 \\
      --op scan,sort,join,aggregate -n 16 -r 3

On a multi-GPU host, omit --virtual and the mesh prefixes the real cards
(one process drives all of them; collectives ride NVLink through NCCL).

`--multiproc P` is a CPU SIMULATION of the N-host leg of the north-star
sweep (1 device / 1 host / N hosts): the bench re-launches itself as P
jax.distributed worker processes, each forced onto the CPU with --virtual
devices (Gloo as the network stand-in — parallel/multiproc.py), measures
every operator over the process-spanning global mesh at 1 and P hosts,
and reports rows/s plus weak-scaling efficiency per host. It never points
several processes at one card:

  python -m cl_ops_tpu.bench.scaling_bench --multiproc 2 --virtual 4 \\
      --op scan,join -n 16 -r 3
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--op", default="scan,sort,join,aggregate",
                   help="comma list of scan,sort,join,aggregate,"
                        "window,topk")
    p.add_argument("--devices", default="",
                   help="comma list of mesh sizes (default: powers of 2 "
                        "up to the available device count)")
    p.add_argument("-n", "--log2-rows", type=int, default=20,
                   help="rows per device = 2^n (weak) or total rows = 2^n "
                        "(strong); default 20")
    p.add_argument("--scaling", default="weak", choices=["weak", "strong"])
    p.add_argument("-r", "--runs", type=int, default=10)
    p.add_argument("--groups", type=int, default=1 << 16,
                   help="aggregate: total distinct keys (default 65536)")
    p.add_argument("--build-frac", type=int, default=16,
                   help="join: build side = probe rows / build_frac")
    p.add_argument("--virtual", type=int, default=0,
                   help="simulate N CPU devices (sets "
                        "xla_force_host_platform_device_count; must be the "
                        "first jax use in the process)")
    p.add_argument("--multiproc", type=int, default=0,
                   help="N-host leg: spawn P jax.distributed worker "
                        "processes (--virtual devices each, default 4) and "
                        "measure 1 vs P hosts over the global mesh")
    p.add_argument("--mp-worker", type=int, default=None,
                   help=argparse.SUPPRESS)  # internal: worker process id
    p.add_argument("--mp-port", type=int, default=0,
                   help=argparse.SUPPRESS)  # internal: coordinator port
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("-o", "--out", default=None, help="TSV output path")
    return p


def _device_counts(arg: str, available: int) -> list[int]:
    if arg:
        return [int(x) for x in arg.split(",") if x]
    counts, k = [], 1
    while k <= available:
        counts.append(k)
        k *= 2
    return counts


def _mp_parent(args) -> int:
    """Spawn the 1-host and P-host legs; report weak-scaling efficiency.

    Each leg runs `nproc` jax.distributed worker processes of this same
    CLI (Gloo coordinator on localhost); worker 0 prints one MPROW line
    per operator with the measured seconds over the global mesh."""
    import subprocess
    from cl_ops_tpu.bench import common
    dev_per_proc = args.virtual or 4
    ops = [o.strip() for o in args.op.split(",") if o.strip()]
    rows = []
    base = {}  # op -> (rate, nproc)
    for nproc in sorted({1, args.multiproc}):
        port = 23000 + (os.getpid() * 7 + nproc) % 9000
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count="
                            f"{dev_per_proc}")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        cmd = [sys.executable, "-m", "cl_ops_tpu.bench.scaling_bench",
               "--multiproc", str(nproc), "--mp-port", str(port),
               "--op", args.op, "-n", str(args.log2_rows),
               "-r", str(args.runs), "-s", str(args.rng_seed),
               "--scaling", args.scaling, "--groups", str(args.groups),
               "--build-frac", str(args.build_frac)]
        if args.no_check:
            cmd.append("--no-check")
        procs = [subprocess.Popen(cmd + ["--mp-worker", str(pid)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env) for pid in range(nproc)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=1200)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for pid, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(f"worker {pid}/{nproc} failed:\n{out[-4000:]}",
                      file=sys.stderr)
                return 1
        for line in outs[0].splitlines():
            if not line.startswith("MPROW\t"):
                continue
            _, op, n_s, secs_s = line.split("\t")
            n, secs = int(n_s), float(secs_s)
            rate = common.throughput_m(n, args.runs, secs)
            b_rate, b_np = base.setdefault(op, (rate, nproc))
            per_host = (rate / nproc) / (b_rate / b_np)
            eff = per_host if args.scaling == "weak" else \
                (rate / b_rate) / (nproc / b_np)
            row = dict(op=op, hosts=nproc,
                       devices=nproc * dev_per_proc, rows=n,
                       mrows_s=round(rate, 1),
                       speedup=round(rate / b_rate, 3),
                       efficiency=round(eff, 3))
            rows.append(row)
            print("\t".join(f"{c}={v}" for c, v in row.items()),
                  flush=True)
    if args.out:
        common.write_tsv(args.out, rows)
    return 0


def _mp_worker(args) -> int:
    """One simulated host: join the process group, run the sweep ops over
    the process-spanning global mesh, print timings from worker 0."""
    from cl_ops_tpu.parallel import multiproc
    multiproc.init_process(args.mp_worker, args.multiproc,
                           coordinator=f"localhost:{args.mp_port}")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cl_ops_tpu.bench import common
    from cl_ops_tpu.parallel import (dist_group_aggregate, dist_hash_join,
                                     dist_scan, dist_sort)
    from cl_ops_tpu.parallel.mesh import replicated_sum_int

    pid, nproc = args.mp_worker, args.multiproc
    mesh = multiproc.global_mesh()
    k = mesh.shape["data"]
    ops = [o.strip() for o in args.op.split(",") if o.strip()]
    rng = np.random.RandomState(args.rng_seed)
    rows_base = 1 << args.log2_rows
    n = rows_base * k if args.scaling == "weak" else rows_base
    lo, hi = pid * (n // nproc), (pid + 1) * (n // nproc)

    def cap_for(rows_shard: int) -> int:
        return max(2 * rows_shard // k + 64, 128)

    def local(full):
        return multiproc.from_process_local(full[lo:hi], mesh)

    for op in ops:
        if op == "scan":
            x = rng.randint(0, 128, size=n, dtype=np.uint32)
            gx = local(x)
            fn = jax.jit(lambda a: dist_scan(a, mesh, sum_dtype=jnp.uint32))
            fargs = (gx,)

            def check(out, x=x):
                xs = x.astype(np.uint64)
                ref = ((np.cumsum(xs) - xs) & 0xFFFFFFFF).astype(
                    np.uint32)[lo:hi]
                assert np.array_equal(multiproc.local_rows(out), ref)
        elif op == "sort":
            x = common.rand_array(np.uint32, n, args.rng_seed)
            gx = local(x)
            fn = jax.jit(lambda a: dist_sort(a, mesh))
            fargs = (gx,)

            def check(out, x=x):
                assert np.array_equal(multiproc.local_rows(out),
                                      np.sort(x)[lo:hi])
        elif op == "aggregate":
            keys = rng.randint(0, args.groups, size=n).astype(np.int32)
            vals = np.ones(n, np.int32)
            per_chip_groups = min(args.groups, 2 * args.groups // k + 256)
            fn = jax.jit(lambda a, b: dist_group_aggregate(
                a, b, mesh, num_groups=per_chip_groups,
                capacity=cap_for(n // k),
                check="defer"))
            fargs = (local(keys), local(vals))

            def check(out, keys=keys):
                _, table, cnt, dropped = out
                assert replicated_sum_int(dropped, mesh) == 0
                assert replicated_sum_int(cnt, mesh) == len(
                    np.unique(keys))
        elif op == "join":
            nb = max(n // args.build_frac, k)
            nb -= nb % k
            bk = rng.permutation(nb).astype(np.int32)
            pk = rng.randint(0, nb, size=n).astype(np.int32)
            blo, bhi = pid * (nb // nproc), (pid + 1) * (nb // nproc)
            gb = multiproc.from_process_local(bk[blo:bhi], mesh)
            gv = multiproc.from_process_local(
                (bk[blo:bhi] * 2 + 1).astype(np.int32), mesh)
            fn = jax.jit(lambda b, v, p: dist_hash_join(
                b, v, p, mesh, capacity_build=cap_for(nb // k),
                capacity_probe=cap_for(n // k),
                check="defer"))
            fargs = (gb, gv, local(pk))

            def check(out, pk=pk):
                found, vals_o, dropped = out
                assert all(replicated_sum_int(d, mesh) == 0
                           for d in dropped)
                fl = multiproc.local_rows(found)
                assert bool(fl.all()), "join missed rows"
                assert np.array_equal(multiproc.local_rows(vals_o),
                                      pk[lo:hi] * 2 + 1)
        elif op == "window":
            from cl_ops_tpu.parallel import dist_window_cols
            keys = rng.randint(0, args.groups, size=n).astype(np.uint32)
            order = rng.randint(0, 1 << 20, size=n).astype(np.int32)
            vals = np.ones(n, np.int32)
            fn = jax.jit(lambda a, o, v: dist_window_cols(
                a, o, (v,), ("sum",), mesh))
            fargs = (local(keys), local(order), local(vals))

            def check(out, keys=keys):
                (sums,) = out
                s = multiproc.local_rows(sums)
                kl = keys[lo:hi]
                expect = np.bincount(keys, minlength=args.groups)
                # every local row's running sum is within its partition
                # count (full-equality oracle lives in tests/mp_worker.py)
                assert bool((s <= expect[kl]).all()), "window overran count"
        elif op == "topk":
            from cl_ops_tpu.parallel import dist_top_k
            x = common.rand_array(np.uint32, n, args.rng_seed)
            kk = min(128, n // k)
            fn = jax.jit(lambda a: dist_top_k(a, kk, mesh))
            fargs = (local(x),)

            def check(out, x=x):
                (tv,) = out
                assert np.array_equal(np.asarray(tv), np.sort(x)[:kk])
        else:
            raise SystemExit(f"unknown op {op!r}")
        secs = common.time_async(fn, fargs, args.runs)
        if not args.no_check:
            check(fn(*fargs))
        if pid == 0:
            print(f"MPROW\t{op}\t{n}\t{secs}", flush=True)
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mp_worker is not None:
        return _mp_worker(args)
    if args.multiproc:
        return _mp_parent(args)
    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={args.virtual}")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cl_ops_tpu.bench import common
    from cl_ops_tpu.defer import verify_deferred
    from cl_ops_tpu.parallel import (dist_group_aggregate, dist_hash_join,
                                     dist_scan, dist_sort)
    from cl_ops_tpu.parallel.mesh import make_mesh, put_sharded

    ops = [o.strip() for o in args.op.split(",") if o.strip()]
    avail = len(jax.devices())
    counts = _device_counts(args.devices, avail)
    if not counts or max(counts) > avail:
        # make_mesh would silently truncate an oversized request,
        # mislabeling every row and corrupting the efficiency column
        need = max(counts) if counts else "a device count"
        print(f"only {avail} devices available; need {need}",
              file=sys.stderr)
        return 1
    rng = np.random.RandomState(args.rng_seed)
    rows_base = 1 << args.log2_rows

    def cap_for(rows_shard: int, k: int) -> int:
        # uniform-key expected bucket load = shard/k; 2x headroom + slack
        return max(2 * rows_shard // k + 64, 128)

    def make_case(op: str, k: int, mesh):
        n = rows_base * k if args.scaling == "weak" else rows_base
        if n % k:
            raise SystemExit(f"rows {n} not divisible by {k} devices")
        shard = n // k
        if op == "scan":
            # u32 sums (u64 would need jax_enable_x64); the reference
            # scan bench likewise keeps values small to delay overflow
            # (clo_scan_bench.c:219-224) — and the check wraps mod 2^32.
            x = put_sharded(rng.randint(0, 128, size=n, dtype=np.uint32),
                            mesh)
            fn = jax.jit(lambda a: dist_scan(a, mesh, sum_dtype=jnp.uint32))

            def check(out):
                xs = np.asarray(x, np.uint64)
                ref = ((np.cumsum(xs) - xs) & 0xFFFFFFFF).astype(np.uint32)
                assert np.array_equal(np.asarray(out), ref), "scan mismatch"
            return fn, (x,), n, check
        if op == "sort":
            x = put_sharded(common.rand_array(np.uint32, n,
                                              args.rng_seed), mesh)
            fn = jax.jit(lambda a: dist_sort(a, mesh))

            def check(out):
                assert np.array_equal(np.sort(np.asarray(x)),
                                      np.asarray(out)), "sort mismatch"
            return fn, (x,), n, check
        if op == "aggregate":
            keys = rng.randint(0, args.groups, size=n).astype(np.int32)
            vals = np.ones(n, np.int32)
            karr = put_sharded(keys, mesh)
            varr = put_sharded(vals, mesh)
            # hash-balanced distinct-keys-per-chip share, 2x margin
            per_chip_groups = min(args.groups, 2 * args.groups // k + 256)
            fn = jax.jit(lambda a, b: dist_group_aggregate(
                a, b, mesh, num_groups=per_chip_groups,
                capacity=cap_for(shard, k),
                check="defer"))

            def check(out):
                gk, table, cnt, dropped = out
                verify_deferred(dropped, op_name="dist_group_aggregate")
                assert int(np.asarray(table).sum()) == n, "aggregate mismatch"
                assert int(np.asarray(cnt).sum()) == len(np.unique(keys))
            return fn, (karr, varr), n, check
        if op == "join":
            nb = max(n // args.build_frac, k)
            bk = rng.permutation(nb).astype(np.int32)
            pk = rng.randint(0, nb, size=n).astype(np.int32)
            bka = put_sharded(bk, mesh)
            bva = put_sharded((bk * 2 + 1).astype(np.int32), mesh)
            pka = put_sharded(pk, mesh)
            fn = jax.jit(lambda b, v, p: dist_hash_join(
                b, v, p, mesh, capacity_build=cap_for(nb // k, k),
                capacity_probe=cap_for(shard, k),
                check="defer"))

            def check(out):
                found, vals_o, dropped = out
                verify_deferred(dropped, op_name="dist_hash_join")
                assert bool(np.asarray(found).all()), "join missed rows"
                assert np.array_equal(np.asarray(vals_o),
                                      pk * 2 + 1), "join values wrong"
            return fn, (bka, bva, pka), n, check
        if op == "window":
            from cl_ops_tpu.parallel import dist_window_cols
            keys = rng.randint(0, args.groups, size=n).astype(np.uint32)
            order = rng.randint(0, 1 << 20, size=n).astype(np.int32)
            vals = np.ones(n, np.int32)
            ka, oa, va = (put_sharded(a, mesh) for a in (keys, order, vals))
            fn = jax.jit(lambda a, o, v: dist_window_cols(
                a, o, (v,), ("sum",), mesh))

            def check(out):
                (sums,) = out
                # per-partition running sums of ones end at the count
                got = np.zeros(args.groups, np.int64)
                s = np.asarray(sums)
                np.maximum.at(got, keys, s)
                expect = np.bincount(keys, minlength=args.groups)
                assert np.array_equal(got, expect), "window mismatch"
            return fn, (ka, oa, va), n, check
        if op == "topk":
            from cl_ops_tpu.parallel import dist_top_k
            x = put_sharded(common.rand_array(np.uint32, n,
                                              args.rng_seed), mesh)
            kk = min(128, shard)
            fn = jax.jit(lambda a: dist_top_k(a, kk, mesh))

            def check(out):
                (tv,) = out
                assert np.array_equal(np.asarray(tv),
                                      np.sort(np.asarray(x))[:kk])
            return fn, (x,), n, check
        raise SystemExit(f"unknown op {op!r}")

    results = []
    for op in ops:
        base_rate = None
        base_k = None
        for k in counts:
            mesh = make_mesh(k)
            fn, fargs, n, check = make_case(op, k, mesh)
            secs = common.time_async(fn, fargs, args.runs)
            if not args.no_check:
                check(fn(*fargs))
            rate = common.throughput_m(n, args.runs, secs)  # Mrows/s
            if base_rate is None:
                base_rate, base_k = rate, k
            speedup = rate / base_rate
            per_dev = (rate / k) / (base_rate / base_k)
            eff = per_dev if args.scaling == "weak" else \
                speedup / (k / base_k)
            row = dict(op=op, devices=k, rows=n,
                       mrows_s=round(rate, 1),
                       speedup=round(speedup, 3),
                       efficiency=round(eff, 3))
            results.append(row)
            print("\t".join(f"{c}={v}" for c, v in row.items()), flush=True)
    if args.out:
        common.write_tsv(args.out, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
