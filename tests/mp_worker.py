"""Multi-process simulation worker: one simulated host.

Spawned by tests/test_multiproc.py (and runnable by hand):
    python tests/mp_worker.py <pid> <nproc> <port>
with JAX_PLATFORMS=cpu and --xla_force_host_platform_device_count=D in
XLA_FLAGS. Every process builds IDENTICAL full inputs from fixed seeds,
contributes its row block, runs the distributed operators over the
N*D-device global mesh, and verifies its local output rows against the
numpy oracle. Prints MP_OK_<pid> on success.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")


def main(pid: int, nproc: int, port: int) -> None:
    from cl_ops_tpu.parallel import multiproc
    multiproc.init_process(pid, nproc, coordinator=f"localhost:{port}")
    import jax
    import numpy as np
    from cl_ops_tpu import parallel

    mesh = multiproc.global_mesh()
    n_chips = mesh.shape["data"]
    n = n_chips * 512
    lo, hi = pid * (n // nproc), (pid + 1) * (n // nproc)

    # --- dist_scan across processes (all_gather carry crosses processes)
    x = np.random.RandomState(1).randint(0, 1000, size=n).astype(np.uint32)
    gx = multiproc.from_process_local(x[lo:hi], mesh)
    out = parallel.dist_scan(gx, mesh, sum_dtype=np.uint64)
    expect = (np.cumsum(x.astype(np.uint64)) - x)[lo:hi]
    np.testing.assert_array_equal(multiproc.local_rows(out), expect)

    # --- dist_sort (hypercube ppermute exchange crosses processes)
    k = np.random.RandomState(2).randint(
        0, 1 << 31, size=n, dtype=np.int64).astype(np.uint32)
    gk = multiproc.from_process_local(k[lo:hi], mesh)
    sorted_k = parallel.dist_sort(gk, mesh)
    np.testing.assert_array_equal(multiproc.local_rows(sorted_k),
                                  np.sort(k)[lo:hi])

    # --- dist_group_aggregate (all_to_all partition exchange crosses processes)
    keys = np.random.RandomState(3).randint(0, 97, size=n).astype(np.uint32)
    vals = np.random.RandomState(4).randint(0, 50, size=n).astype(np.int32)
    gkeys = multiproc.from_process_local(keys[lo:hi], mesh)
    gvals = multiproc.from_process_local(vals[lo:hi], mesh)
    gk2, table, cnt = parallel.dist_group_aggregate(
        gkeys, gvals, mesh, num_groups=128, capacity=n, agg="sum")
    from cl_ops_tpu.parallel.mesh import replicated_sum_int
    assert replicated_sum_int(cnt, mesh) == len(np.unique(keys))
    expect_agg = {int(u): int(vals[keys == u].sum()) for u in np.unique(keys)}
    gk2l = multiproc.local_rows(gk2).reshape(n_chips // nproc, -1)
    tabl = multiproc.local_rows(table).reshape(n_chips // nproc, -1)
    cntl = multiproc.local_rows(cnt).reshape(-1)
    for c in range(n_chips // nproc):
        for i in range(cntl[c]):
            assert expect_agg[int(gk2l[c, i])] == int(tabl[c, i])

    # --- dist_hash_join under Zipf skew: hash buckets overflow at the
    # uniform share, the adaptive re-plan (range splitters + capacity
    # doubling) must return the exact answer with zero row loss
    from cl_ops_tpu.parallel.join import dist_hash_join
    nb = n_chips * 32
    dim = np.arange(nb, dtype=np.uint32)
    dimv = (dim * 5 + 3).astype(np.int32)
    probe = (np.random.default_rng(5).zipf(1.2, size=n)
             % (1 << 14)).astype(np.uint32)
    gd = multiproc.from_process_local(dim[pid * nb // nproc:
                                          (pid + 1) * nb // nproc], mesh)
    gdv = multiproc.from_process_local(dimv[pid * nb // nproc:
                                            (pid + 1) * nb // nproc], mesh)
    gp = multiproc.from_process_local(probe[lo:hi], mesh)
    cap_probe = (n // n_chips) // n_chips * 2
    found, fv = dist_hash_join(gd, gdv, gp, mesh, capacity_build=nb,
                               capacity_probe=cap_probe,
                               samples_per_chip=64)
    expect_f = probe[lo:hi] < nb
    np.testing.assert_array_equal(multiproc.local_rows(found), expect_f)
    fvl = multiproc.local_rows(fv)
    np.testing.assert_array_equal(
        fvl[expect_f], (probe[lo:hi][expect_f] * 5 + 3).astype(np.int32))

    # --- distributed full expansion (partition-sharded output pairs):
    # verify THIS process's partitions against the global oracle multiset
    from cl_ops_tpu.parallel.join import dist_hash_join_expand
    nb2 = n_chips * 16
    b2 = np.sort(np.random.RandomState(6).randint(
        0, 64, size=nb2).astype(np.uint32))
    bv2 = np.arange(nb2, dtype=np.int32) + 11
    p2 = np.random.RandomState(7).randint(0, 80, size=n).astype(np.uint32)
    cap_out = 8 * n // n_chips
    g_b2 = multiproc.from_process_local(b2[pid * nb2 // nproc:
                                           (pid + 1) * nb2 // nproc], mesh)
    g_bv2 = multiproc.from_process_local(bv2[pid * nb2 // nproc:
                                             (pid + 1) * nb2 // nproc], mesh)
    g_p2 = multiproc.from_process_local(p2[lo:hi], mesh)
    totals, pidx, vals = dist_hash_join_expand(
        g_b2, g_bv2, g_p2, mesh, capacity_build=nb2, capacity_probe=n,
        capacity_out=cap_out)
    tl = multiproc.local_rows(totals).reshape(-1)
    pl = multiproc.local_rows(pidx).reshape(len(tl), cap_out)
    vl = multiproc.local_rows(vals).reshape(len(tl), cap_out)
    got = []
    for c in range(len(tl)):
        assert tl[c] <= cap_out
        got.extend(zip(pl[c, :tl[c]].tolist(), vl[c, :tl[c]].tolist()))
    # oracle: pairs whose key lands on one of THIS process's chips
    from cl_ops_tpu.parallel.splitters import hash_partition_ids
    import jax.numpy as jnp_
    my_chips = set(range(pid * (n_chips // nproc),
                         (pid + 1) * (n_chips // nproc)))
    part_of = np.asarray(hash_partition_ids(jnp_.asarray(p2), n_chips))
    expect_pairs = []
    for i, pk_ in enumerate(p2):
        if int(part_of[i]) not in my_chips:
            continue
        for bkey, bval in zip(b2, bv2):
            if bkey == pk_:
                expect_pairs.append((i, int(bval)))
    assert sorted(got) == sorted(expect_pairs)

    # --- distributed window functions across processes: the global sort's
    # compare-split ppermutes AND the segmented-scan carries cross processes
    wkeys = (keys % 5).astype(np.uint32)
    gwk = multiproc.from_process_local(wkeys[lo:hi], mesh)
    worder = multiproc.from_process_local(vals[lo:hi], mesh)
    (wsum,) = parallel.dist_window_cols(gwk, worder, (worder,), ("sum",),
                                        mesh)
    # serial oracle: running sum per (key) partition in (order, pos) order
    osum = np.zeros(n, np.int64)
    for u in np.unique(wkeys):
        idx = np.nonzero(wkeys == u)[0]
        idx = idx[np.argsort(vals[idx], kind="stable")]
        osum[idx] = np.cumsum(vals[idx].astype(np.int64))
    np.testing.assert_array_equal(
        multiproc.local_rows(wsum).astype(np.int64), osum[lo:hi])

    # --- distributed top-k and distinct (candidate merges cross processes)
    gk3 = multiproc.from_process_local(k[lo:hi], mesh)
    tvals, = parallel.dist_top_k(gk3, 8, mesh)
    np.testing.assert_array_equal(np.asarray(tvals), np.sort(k)[:8])
    uq, ucnt = parallel.dist_distinct(gwk, mesh, capacity=16)
    assert int(np.asarray(ucnt)) == len(np.unique(wkeys))

    print(f"MP_OK_{pid}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
