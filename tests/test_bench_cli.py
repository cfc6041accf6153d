"""Bench CLI smoke tests (tiny sizes, CPU) — the reference's L4 surface."""

import os

import numpy as np
import pytest


def test_sort_bench_cli(tmp_path):
    from cl_ops_tpu.bench import sort_bench
    out = tmp_path / "sort.tsv"
    rc = sort_bench.main(["-a", "xla", "-r", "1", "--minpo2", "4",
                          "--maxpo2", "6", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0].startswith("n\t")
    assert len(lines) == 4  # header + 3 sizes


def test_scan_bench_cli(tmp_path):
    from cl_ops_tpu.bench import scan_bench
    out = tmp_path / "scan.tsv"
    rc = scan_bench.main(["-a", "xla", "-r", "1", "--min-doub", "2",
                          "-n", "4", "--out", str(out)])
    assert rc == 0
    assert out.exists()


def test_rng_bench_cli_dieharder(tmp_path):
    from cl_ops_tpu.bench import rng_bench
    out = tmp_path / "rng.dh"
    rc = rng_bench.main(["-g", "threefry", "--gws", "64", "-r", "4",
                         "--output", "file-dh", "--out-file", str(out)])
    assert rc == 0
    head = out.read_text().split("\n")[:3]
    assert head[0] == "type: d"
    assert head[1] == "count: 256"
    assert head[2] == "numbit: 32"


def test_rng_bench_cli_tsv_and_plot(tmp_path):
    from cl_ops_tpu.bench import rng_bench, plot_rng
    tsv = tmp_path / "rng.tsv"
    rc = rng_bench.main(["-g", "mwc64x", "--gws", "32", "-r", "32",
                        "--output", "file-tsv", "--out-file", str(tsv)])
    assert rc == 0
    m = np.loadtxt(tsv, delimiter="\t")
    assert m.shape == (32, 32)
    png = tmp_path / "rng.png"
    rc = plot_rng.main([str(tsv), "--out", str(png)])
    if rc == 0:  # matplotlib present
        assert png.exists()


def test_rng_bench_bits_and_maxint(capsys):
    from cl_ops_tpu.bench import rng_bench
    rc = rng_bench.main(["-g", "lcg", "--gws", "16", "-r", "2",
                         "--bits", "8", "--output", "stdout-uint"])
    assert rc == 0
    vals = [int(v) for v in capsys.readouterr().out.split()]
    assert all(0 <= v < 256 for v in vals)
    rc = rng_bench.main(["-g", "lcg", "--gws", "16", "-r", "2",
                         "--max-int", "9", "--output", "stdout-uint"])
    assert rc == 0
    vals = [int(v) for v in capsys.readouterr().out.split()]
    assert all(0 <= v <= 9 for v in vals)


def test_exec_bench_cli(capsys):
    from cl_ops_tpu.bench import exec_bench
    for op, extra in (("filter", []), ("aggregate", ["--groups", "256"]),
                      ("join", ["--dim-log2", "8"])):
        rc = exec_bench.main(["--op", op, "-n", "12", "-r", "1"] + extra)
        assert rc == 0
        assert op in capsys.readouterr().out


def test_bench_all_smoke(capsys, tmp_path, monkeypatch):
    """bench_all emits one JSON line per config, each naming its device;
    a scaled smoke run writes no record file."""
    import json
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_all
    monkeypatch.chdir(tmp_path)
    rc = bench_all.main(["--scale", "4096", "--runs", "1"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip()
             .split("\n") if l.startswith("{")]
    metrics = {l["metric"] for l in lines}
    assert all(l["platform"] == "cpu" and l["device_count"] >= 1
               and "roofline_frac" not in l for l in lines)
    assert metrics == {"sort_u32_1M", "sort_u64kv_16M", "filter_64M_sel10",
                       "aggregate_256M_1Mgroups", "join_probe_16Mx1M",
                       "join_probe_16Mx1M_sorted",
                       "join_probe_16Mx1M_merge", "join_expand_16Mx4",
                       "rollup_16Mx1M", "q1_16Mx64K",
                       "window_16Mx64K", "window_16Mx64K_sorted",
                       "topk_1K_of_64M", "distinct_64M_1M",
                       "join_probe_256Mx16M"}
    assert not list(tmp_path.iterdir())


def test_scaling_bench_cli(tmp_path):
    from cl_ops_tpu.bench import scaling_bench
    out = tmp_path / "scaling.tsv"
    rc = scaling_bench.main(["--op", "scan,join", "--devices", "1,8",
                             "-n", "10", "-r", "1", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0].split("\t") == ["op", "devices", "rows", "mrows_s",
                                    "speedup", "efficiency"]
    assert len(lines) == 5  # header + 2 ops x 2 device counts
    # weak scaling: the 8-device rows process 8x the rows (exactness of
    # every op's output is asserted inside the bench's own check)
    rows = [dict(zip(lines[0].split("\t"), l.split("\t"))) for l in lines[1:]]
    for r in rows:
        assert int(r["rows"]) == (1 << 10) * int(r["devices"])


def test_scaling_bench_rejects_oversized_device_request(tmp_path):
    from cl_ops_tpu.bench import scaling_bench
    # 16 is not last in the list: make_mesh would silently truncate it
    rc = scaling_bench.main(["--op", "scan", "--devices", "16,8",
                             "-n", "8", "-r", "1"])
    assert rc == 1


def test_scaling_bench_multiproc(tmp_path):
    """The N-host leg, a CPU simulation: 2 jax.distributed worker
    processes x 2 CPU devices, measured at 1 and 2 hosts with exactness
    checks inside each worker."""
    from cl_ops_tpu.bench import scaling_bench
    out = tmp_path / "mp.tsv"
    rc = scaling_bench.main(["--multiproc", "2", "--virtual", "2",
                             "--op", "scan,join", "-n", "8", "-r", "1",
                             "--out", str(out)])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0].split("\t") == ["op", "hosts", "devices", "rows",
                                    "mrows_s", "speedup", "efficiency"]
    rows = [dict(zip(lines[0].split("\t"), l.split("\t")))
            for l in lines[1:]]
    assert {(r["op"], r["hosts"]) for r in rows} == {
        ("scan", "1"), ("scan", "2"), ("join", "1"), ("join", "2")}
    for r in rows:  # weak scaling: rows grow with the global mesh
        assert int(r["rows"]) == (1 << 8) * 2 * int(r["hosts"])
