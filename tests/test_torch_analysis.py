"""The port's kernel-contract checker (``repro_torch.analysis``) on the
CPU, held to the JAX checker where the two share a meaning.

- findings, reports and the allowlist: the port's copy against
  ``repro.analysis.findings`` (keys, dedup, gating, allowlist matches);
- the fixtures: each plain version against the JAX kernel body run
  through ``pl.pallas_call(..., interpret=True)`` on the same seeded
  numpy inputs, bit for bit; the CPU-checkable fixtures (host fetch,
  rung realloc) caught at their ``.py`` lines; the kernel fixtures'
  committed PTX (``tests/data/fixtures.ptx``, captured on the H100)
  caught at their ``fixtures.cu`` lines;
- the contracts clean on the real tree with ``device="cpu"``, the
  tiers' allocations along the lattice equal to the JAX tiers', the
  shared-memory model against the C launchers' arithmetic transcribed;
- the PTX lints on hand-written fragments, the ptxas log parser, the
  profiler-trace parser behind ``lint:batch-loop``, and the CLI.

The JAX checker's fixture goldens and its clean pass on the real entry
points fail on this tree (ROADMAP queue C), so no port test is held to
them; ``test_fixture_classes_match_the_jax_checker`` compares which
contract catches which bug class instead.
"""

import collections
import contextlib
import io
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import repro.analysis.findings as jfind
import repro.analysis.fixtures as jfix
from repro_torch.analysis import alloc, contracts, ptx_checks, smem
from repro_torch.analysis import findings as tfind
from repro_torch.analysis import fixtures as tfix
from repro_torch.analysis.__main__ import DEFAULT_ALLOWLIST, main
from repro_torch.kernels import build
from repro_torch.utils import ptx as tptx

ROOT = Path(__file__).resolve().parents[1]
FIXTURE_PTX = ROOT / "tests" / "data" / "fixtures.ptx"
FIXTURES_CU = ROOT / "src" / "repro_torch" / "analysis" / "csrc" / "fixtures.cu"


# ------------------------------------------------- findings / allowlist
_CASES = [
    dict(contract="lint", entry="fused_lookup",
         location="/abs/path/src/repro/kernels/fused_lookup.py:334",
         message="m"),
    dict(contract="host-sync", entry="FlatAFLI.scan_batch",
         location="/x/flat_afli.py:1220", message="over budget: 6"),
    dict(contract="lint:clamp-gather", entry="index_probe_kernel",
         location="index_probe.cu:61", message="clamped gather: x"),
    dict(contract="smem", entry="cfg", location="", message="m"),
]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c["contract"])
def test_finding_key_and_json_parity(case):
    a, b = jfind.Finding(**case), tfind.Finding(**case)
    assert a.key() == b.key()
    assert a.to_json() == b.to_json()


def _fill(mod, allow):
    rep = mod.Report(allowlist=allow)
    seq = [
        mod.Finding(contract="lint", entry="e", location="a.py:1",
                    message="clip-mode gather: one"),
        mod.Finding(contract="lint", entry="e", location="a.py:1",
                    message="clip-mode gather: two"),          # deduped
        mod.Finding(contract="smem", entry="c", location="b.cu:9",
                    message="m", severity="info"),
        mod.Finding(contract="host-sync", entry="x", location="c.py:3",
                    message="over budget: 2"),
    ]
    for f in seq:
        rep.add(f)
    rep.note_pass("e", "lint")
    return rep


@pytest.mark.parametrize("allow_text", ["", "# reviewed\nlint e a.py:*  # ok\n",
                                        "host-sync x c.py:3\n"])
def test_report_dedup_gating_and_allowlist_parity(tmp_path, allow_text):
    path = tmp_path / "allow.txt"
    path.write_text(allow_text)
    ja = _fill(jfind, jfind.load_allowlist(str(path)))
    ta = _fill(tfind, tfind.load_allowlist(str(path)))
    assert jfind.load_allowlist(str(path)) == tfind.load_allowlist(str(path))
    for q in ("blocking", "allowed", "advisory"):
        assert ([f.key() for f in getattr(ja, q)()]
                == [f.key() for f in getattr(ta, q)()])
    assert ja.ok == ta.ok and ja.render() == ta.render()
    assert json.loads(ja.to_json()) == json.loads(ta.to_json())


def test_the_port_allowlist_loads_alike_and_every_line_has_a_reason():
    assert (jfind.load_allowlist(DEFAULT_ALLOWLIST)
            == tfind.load_allowlist(DEFAULT_ALLOWLIST))
    pats = 0
    for raw in Path(DEFAULT_ALLOWLIST).read_text().splitlines():
        pat, _, why = raw.partition("#")
        if not pat.strip():
            continue
        pats += 1
        assert why.strip(), f"allowlist line without a reason: {raw!r}"
        if pat.startswith("host-sync"):
            assert re.search(r"\bA\d+[a-z]?\b", why), raw
    assert pats >= 30
    assert tfind.CONTRACTS == ("host-sync", "alloc-budget", "smem", "lint")


# ------------------------------------------------- fixtures vs the JAX bodies
def _pallas(kernel, out_shape, *args):
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape,
                                     interpret=True)(*args))


def test_clip_gather_plain_equals_the_jax_body():
    rng = np.random.default_rng(0)
    idx = rng.integers(-40, 171, 128).astype(np.int32)
    idx[:4] = [-40, -1, 127, 170]
    table = rng.standard_normal(128).astype(np.float32)
    want = _pallas(jfix._clip_gather_kernel,
                   jax.ShapeDtypeStruct((128,), jnp.float32), idx, table)
    got = tfix.clip_gather(torch.from_numpy(idx), torch.from_numpy(table))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_lane_cast_plain_equals_the_jax_body():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 1 << 32, 128, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 128, dtype=np.uint64).astype(np.uint32)
    hi[:3], lo[:3] = [0, 0xFFFFFFFF, 1 << 24], [0, 0xFFFFFFFF, (1 << 24) + 1]
    want = _pallas(jfix._lane_cast_kernel,
                   jax.ShapeDtypeStruct((128,), jnp.float32), hi, lo)
    got = tfix.lane_cast(torch.from_numpy(hi.view(np.int32)),
                         torch.from_numpy(lo.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the bug the fixture carries: distinct identities collide
    assert got[2] == tfix.lane_cast(torch.tensor([1 << 24], dtype=torch.int32),
                                    torch.tensor([1 << 24],
                                                 dtype=torch.int32))[0]


@pytest.mark.parametrize("batch", [1, 33, 4096])
def test_batch_loop_plain_equals_the_jax_body(batch):
    rng = np.random.default_rng(batch)
    q = rng.standard_normal(batch).astype(np.float32)
    pool = rng.standard_normal(256).astype(np.float32)
    k = min(batch, 2)
    q[:k] = pool[:k]                       # ties count (<=)
    want = _pallas(jfix._batch_loop_kernel,
                   jax.ShapeDtypeStruct((batch,), jnp.int32), q, pool)
    got = tfix.batch_loop(torch.from_numpy(q), torch.from_numpy(pool))
    assert np.array_equal(got.numpy(), want)


def test_f64_upcast_plain_equals_searchsorted_of_the_f32_table():
    # the JAX fixture traces an x64 constant table (its enable_x64 is gone
    # from jax 0.9, ROADMAP C); the function is numpy's searchsorted over
    # linspace(0, 1, 8) cut to f32
    table = np.linspace(0.0, 1.0, 8).astype(np.float32)
    assert np.array_equal(tfix.f64_table(8).numpy(), table)
    rng = np.random.default_rng(2)
    pk = np.concatenate([rng.uniform(-0.2, 1.2, 1000), table,
                         np.nextafter(table, 2), np.nextafter(table, -2),
                         [-np.inf, np.inf]]).astype(np.float32)
    got = tfix.f64_upcast(torch.from_numpy(pk))
    assert np.array_equal(got.numpy(), np.searchsorted(table, pk))


def test_fixture_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        tfix.clip_gather(torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError):
        tfix.lane_cast(torch.zeros(4, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tfix.f64_upcast(torch.zeros(4), table_len=1)


def test_fixture_classes_match_the_jax_checker():
    """The JAX fixtures' bug classes, each caught by the port's contract
    of the same meaning (the JAX goldens fail on this tree, queue C)."""
    kernels = {n: f for n, f in tfix.FIXTURES.items() if f.kernel}
    assert set(kernels) <= set(jfix.FIXTURES)
    for name, fixture in kernels.items():
        assert fixture.check.startswith("lint:")  # JAX: the "lint" contract
    # the host round trip and the rung-sized tier
    assert "fixture:host-callback" in jfix.FIXTURES
    assert {"fixture:host-fetch", "fixture:rung-realloc"} <= set(tfix.FIXTURES)
    assert len(tfix.FIXTURES) == len(jfix.FIXTURES) + 1


# ------------------------------------------- CPU-checkable fixtures caught
def _source_line(loc):
    path, _, line = loc.rpartition(":")
    return Path(path).read_text().splitlines()[int(line) - 1]


def test_host_fetch_fixture_caught_at_its_line():
    rep = tfind.Report()
    contracts.check_host_fetch_fixture(rep, "cpu")
    hits = [f for f in rep.blocking() if f.contract == "host-sync"]
    assert hits and all(f.entry == "fixture:host-fetch" for f in hits)
    locs = {Path(f.location).name.split(":")[0] for f in hits}
    assert locs == {"fixtures.py"}
    assert any(".cpu()" in _source_line(f.location) for f in hits)


def test_rung_realloc_fixture_caught_at_its_line():
    rep = tfind.Report()
    alloc.check_rung_realloc_fixture(rep, "cpu")
    hits = [f for f in rep.blocking() if f.contract == "alloc-budget"]
    fixture_sites = [f for f in hits if "fixtures.py" in f.location]
    assert fixture_sites
    assert "self._alloc(rung)" in _source_line(fixture_sites[0].location)
    for f in hits:
        assert len(f.details["allocs"]) > len(set(f.details["declared"]))


def test_fixture_selftest_cli_on_the_cpu(capsys):
    assert main(["--device", "cpu", "--fixtures"]) == 0
    out = capsys.readouterr().out
    assert "caught  fixture:host-fetch  @ fixtures.py:" in out
    assert "caught  fixture:rung-realloc  @ fixtures.py:" in out
    for name, fixture in tfix.FIXTURES.items():
        if fixture.needs_card:
            assert f"not run (needs the card)  {name}" in out


# ----------------------------------------------- the kernel fixtures' PTX
@pytest.mark.parametrize("fixture", sorted(
    n for n, f in tfix.FIXTURES.items() if f.kernel))
def test_committed_fixture_ptx_caught_at_its_cu_line(fixture):
    kernel, check = tfix.FIXTURES[fixture].kernel, tfix.FIXTURES[fixture].check
    rep = tfind.Report()
    found = ptx_checks.check_fixture_kernel(rep, fixture, kernel,
                                            FIXTURE_PTX.read_text())
    src = FIXTURES_CU.read_text().splitlines()
    if check == "lint:batch-loop":
        # B10's class shows in the launch, not in the PTX
        assert not found
        return
    hits = [f for f in found if f.contract == check]
    assert hits and not rep.ok
    lines = []
    for f in hits:
        name, line = f.location.split(":")
        assert name == "fixtures.cu"
        lines.append(src[int(line) - 1])
    want = {"lint:clamp-gather": "min(max(",
            "lint:lane-cast": "__uint2float_rn",
            "lint:f64": "double"}[check]
    assert any(want in text for text in lines), lines


def test_fixture_ptx_census():
    text = FIXTURE_PTX.read_text()
    census = tptx.op_census(text)
    assert census["cvt.rn.f32.u32"] == 2 and census["min.s32"] == 1
    assert tptx.f64_census(text) == sum(v for k, v in census.items()
                                        if "f64" in k.split(".")) > 0
    names = [tptx.kernel_base_name(f.name) for f in tptx.parse_ptx(text)]
    assert names == ["clip_gather_kernel", "lane_cast_kernel",
                     "batch_loop_kernel", "f64_upcast_kernel"]
    assert tptx.normalize_ptx(text) == text


# ------------------------------------------------- PTX lints on fragments
_HEAD = """//
// Generated by NVIDIA NVVM Compiler
//
.version 8.8
.target sm_90a
.address_size 64
"""


def _kernel(body: str) -> str:
    return (_HEAD + ".visible .entry k(\n\t.param .u64 k_param_0\n)\n{\n"
            + body + "\n\tret;\n}\n\t.file\t1 \"/some/where/frag.cu\"\n"
            "\t.file\t2 \"/usr/local/cuda/include/sm_32_intrinsics.hpp\"\n")


def _lint(body):
    rep = tfind.Report()
    return ptx_checks.check_ptx(_kernel(body), rep), rep


def test_clamp_feeding_a_load_is_caught_at_its_loc_line():
    found, _ = _lint("""
	.loc	1 10 3
	ld.param.u64 	%rd1, [k_param_0];
	ld.global.u32 	%r1, [%rd1];
	.loc	1 12 5
	max.s32 	%r2, %r1, 0;
	min.s32 	%r3, %r2, 127;
	.loc	1 13 5
	mul.wide.s32 	%rd2, %r3, 4;
	add.s64 	%rd3, %rd1, %rd2;
	.loc	2 112 47, function_name $L__info_string1, inlined_at 1 14 9
	ld.global.nc.f32 	%f1, [%rd3];""")
    assert [(f.contract, f.location) for f in found] == [
        ("lint:clamp-gather", "frag.cu:12")]
    assert found[0].details["load_loc"] == "frag.cu:14"


def test_select_clamp_feeding_a_load_is_caught():
    # nvcc's form of `s = s < 0 ? 0 : (s > n - 1 ? n - 1 : s)`
    found, _ = _lint("""
	.loc	1 20 3
	ld.param.u64 	%rd1, [k_param_0];
	ld.global.u32 	%r20, [%rd1];
	ld.global.u32 	%r11, [%rd1+4];
	.loc	1 21 3
	setp.lt.s32 	%p2, %r20, 0;
	setp.lt.s32 	%p3, %r20, %r11;
	add.s32 	%r21, %r11, -1;
	selp.b32 	%r22, %r20, %r21, %p3;
	selp.b32 	%r23, 0, %r22, %p2;
	.loc	1 22 3
	mul.wide.s32 	%rd19, %r23, 4;
	add.s64 	%rd16, %rd1, %rd19;
	ld.global.nc.s32 	%r17, [%rd16];""")
    assert [(f.contract, f.location) for f in found] == [
        ("lint:clamp-gather", "frag.cu:21")]


def test_clamp_bounding_only_a_loop_passes():
    found, rep = _lint("""
	.loc	1 30 3
	ld.param.u64 	%rd1, [k_param_0];
	ld.global.u32 	%r1, [%rd1];
	max.s32 	%r2, %r1, 0;
	min.s32 	%r3, %r2, 64;
	mov.u32 	%r4, 0;
$L__BB0_1:
	.loc	1 31 5
	mul.wide.s32 	%rd2, %r4, 4;
	add.s64 	%rd3, %rd1, %rd2;
	ld.global.f32 	%f1, [%rd3];
	add.s32 	%r4, %r4, 1;
	setp.lt.s32 	%p1, %r4, %r3;
	@%p1 bra 	$L__BB0_1;""")
    assert not found and rep.ok and ("k", "lint") in rep.checked


def test_min_or_max_alone_is_not_a_clamp():
    found, _ = _lint("""
	.loc	1 40 3
	ld.param.u64 	%rd1, [k_param_0];
	ld.global.u32 	%r1, [%rd1];
	max.s32 	%r2, %r1, 0;
	mul.wide.s32 	%rd2, %r2, 4;
	add.s64 	%rd3, %rd1, %rd2;
	ld.global.f32 	%f1, [%rd3];""")
    assert not found


def test_lane_casts_and_f64_are_caught():
    found, _ = _lint("""
	.loc	1 50 3
	ld.param.u64 	%rd1, [k_param_0];
	ld.global.u32 	%r1, [%rd1];
	.loc	1 51 3
	cvt.rn.f32.u32 	%f1, %r1;
	.loc	1 52 3
	ld.global.u64 	%rd2, [%rd1+8];
	cvt.u32.u64 	%r2, %rd2;
	.loc	1 53 3
	mov.u64 	%rd3, 1024;
	add.s64 	%rd4, %rd3, %rd1;
	cvt.u32.u64 	%r3, %rd4;
	.loc	1 54 3
	cvt.f64.f32 	%fd1, %f1;
	add.f64 	%fd2, %fd1, 0d3FF0000000000000;""")
    got = {(f.contract, f.location) for f in found}
    assert got == {("lint:lane-cast", "frag.cu:51"),
                   ("lint:lane-cast", "frag.cu:52"),
                   ("lint:f64", "frag.cu:54")}


def test_ptxas_log_parse_and_spill_lint():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z22streamed_lookup_kernelILi32EEv10StreamArgs8NFParams' for 'sm_90a'
ptxas info    : Function properties for _Z22streamed_lookup_kernelILi32EEv10StreamArgs8NFParams
    112 bytes stack frame, 348 bytes spill stores, 564 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 4096 bytes smem, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18index_probe_kernel9ProbeArgs' for 'sm_90a'
ptxas info    : Function properties for _Z18index_probe_kernel9ProbeArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, 456 bytes cmem[0]
"""
    rep = tfind.Report()
    parsed = ptx_checks.check_ptxas_log(log, rep, contracts.kernel_lines())
    sl = parsed["_Z22streamed_lookup_kernelILi32EEv10StreamArgs8NFParams"]
    assert sl == {"stack": 112, "spill_stores": 348, "spill_loads": 564,
                  "registers": 64, "smem": 4096}
    assert parsed["_Z18index_probe_kernel9ProbeArgs"]["smem"] == 0
    assert rep.ok and [f.location for f in rep.advisory()] == [
        "streamed_lookup.cu:194"]
    assert tptx.kernel_base_name(
        "void fused_lookup_kernel<0, 8>(LookupArgs, NFParams)") \
        == "fused_lookup_kernel"


# ------------------------------------------------------ launch facts
def _trace(grid, block, extent_call="entry:fixture:batch-loop#0"):
    return [
        {"cat": "user_annotation", "name": extent_call, "ts": 100.0,
         "dur": 50.0},
        {"cat": "user_annotation", "name": "entry:outer#1", "ts": 90.0,
         "dur": 100.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120.0,
         "args": {"correlation": 7}},
        {"cat": "kernel", "ts": 500.0,
         "name": "batch_loop_kernel(float const*, float const*, int*, int, "
                 "int)",
         "args": {"correlation": 7, "grid": grid, "block": block,
                  "shared memory": 0, "registers per thread": 32}},
        {"cat": "kernel", "name": "void at::native::fill_kernel<...>()",
         "ts": 600.0, "args": {"correlation": 8, "grid": [1, 1, 1],
                               "block": [1, 1, 1]}},
    ]


@pytest.mark.parametrize("grid,block,caught", [([1, 1, 1], [1, 1, 1], True),
                                               ([16, 1, 1], [1, 1, 1], False),
                                               ([32, 1, 1], [128, 1, 1],
                                                False)])
def test_batch_loop_lint_from_launch_facts(grid, block, caught):
    facts = contracts.parse_launch_facts(_trace(grid, block),
                                         set(contracts.kernel_lines()))
    assert [f["kernel"] for f in facts] == ["batch_loop_kernel"]
    assert facts[0]["call"] == "entry:fixture:batch-loop#0"
    entry = contracts.EntryPoint("fixture:batch-loop",
                                 "repro_torch.analysis.fixtures",
                                 "batch_loop", budget=0)
    call = contracts._Call(entry, entry.name, 0, 4096)
    rep = tfind.Report()
    contracts.check_launches(rep, facts, [call])
    hits = [f for f in rep.blocking() if f.contract == "lint:batch-loop"]
    assert bool(hits) == caught
    if caught:
        assert hits[0].location == "fixtures.cu:50"
        assert "__global__" in FIXTURES_CU.read_text().splitlines()[49]


def test_no_kernel_event_fails_the_launch_contract():
    rep = tfind.Report()
    contracts.check_launches(rep, [], [])
    assert not rep.ok and "no kernel event" in rep.blocking()[0].message


# ------------------------------------------------ contracts on the tree
def test_host_sync_contract_clean_on_the_real_tree_cpu():
    rep = tfind.Report(allowlist=tfind.load_allowlist(DEFAULT_ALLOWLIST))
    out = contracts.run_host_sync_checks(rep, "cpu")
    assert rep.ok, rep.render()
    names = {e.name for e in contracts.ENTRY_POINTS}
    assert names <= set(out["syncs"])             # every entry dispatched
    st = out["syncs"]
    # the dispatch halves and the finishers keep their budgets
    for name in ("ops.fused_lookup[fused]", "ops.fused_lookup[streamed]",
                 "FlatAFLI.lookup_batch_async",
                 "ShardedFlatAFLI._fanout_points_async"):
        assert st[name]["max_per_call"] == 0, name
    assert st["FlatAFLI.lookup_batch_async:finish"]["max_per_call"] == 1
    # the reviewed syncs (allowlisted, ROADMAP A6b, A7b, A8c)
    assert st["DeviceTier.refresh"]["max_per_call"] == 4
    assert st["FlatAFLI.scan_batch"]["max_per_call"] == 6
    assert st["ops.fused_range_scan"]["max_per_call"] == 1
    assert {f.key() for f in rep.allowed()} >= {
        "host-sync ops.fused_range_scan ops.py:142",
        "host-sync FlatAFLI.scan_batch flat_afli.py:1336"}


def test_reflow_episode_syncs_counted_and_allowlisted():
    """The world's re-flow episode dispatches both re-flow entries; their
    syncs (the re-key through the NF kernel, the retrainer's steps, the
    snapshot's tier refresh) are counted per call and every one is
    allowlisted with its ROADMAP item."""
    names = ("FlatAFLI.start_reflow", "ReflowManager.tick")
    entries = tuple(e for e in contracts.ENTRY_POINTS if e.name in names)
    assert len(entries) == 2 and all(e.budget == 1 for e in entries)
    rep = tfind.Report(allowlist=tfind.load_allowlist(DEFAULT_ALLOWLIST))
    seen = {}

    def world():
        seen["nfl"] = contracts.reflow_episode(
            "cpu", np.random.default_rng(contracts.WORLD_SEED))

    out = contracts.run_host_sync_checks(rep, "cpu", entries=entries,
                                         world=world, profile=False)
    assert rep.ok, rep.render()
    st = out["syncs"]
    nfl = seen["nfl"]
    assert st["FlatAFLI.start_reflow"]["calls"] == \
        nfl._reflow.reflows_started == nfl.index.n_reflows == 1
    assert st["ReflowManager.tick"]["calls"] >= nfl._reflow.checks
    for name in names:
        assert st[name]["max_per_call"] > 1, name      # over its budget
    keys = {f.key() for f in rep.allowed()}
    assert {"host-sync FlatAFLI.start_reflow ops.py:82",
            "host-sync ReflowManager.tick ops.py:82",
            "host-sync ReflowManager.tick train_flow.py:135"} <= keys
    assert all(f.entry in names for f in rep.allowed())


def test_sharded_episode_entries_dispatch_and_hold_or_are_allowlisted():
    """The sharded episodes' four entries dispatch in the CPU world (its
    migration step and its sharded re-flow episode); the boundary splice
    and the reshard tick hold their budget of 0, and every sync of the
    two starts past their budgets is allowlisted with its ROADMAP item."""
    names = ("ShardedFlatAFLI.start_reflow", "ShardedFlatAFLI.start_reshard",
             "ShardedFlatAFLI._refresh_boundaries", "ReshardManager.tick")
    entries = tuple(e for e in contracts.ENTRY_POINTS if e.name in names)
    assert [e.budget for e in entries] == [1, 0, 0, 0]
    rep = tfind.Report(allowlist=tfind.load_allowlist(DEFAULT_ALLOWLIST))
    out = contracts.run_host_sync_checks(rep, "cpu", entries=entries,
                                         profile=False)
    assert rep.ok, rep.render()
    st = out["syncs"]
    assert st["ShardedFlatAFLI.start_reflow"]["calls"] == 1
    assert st["ShardedFlatAFLI.start_reshard"]["calls"] == 1
    assert st["ShardedFlatAFLI._refresh_boundaries"]["calls"] == 1
    assert st["ReshardManager.tick"]["calls"] >= 1
    for name in ("ShardedFlatAFLI._refresh_boundaries",
                 "ReshardManager.tick"):
        assert st[name]["max_per_call"] == 0, name
    for name in ("ShardedFlatAFLI.start_reflow",
                 "ShardedFlatAFLI.start_reshard"):
        assert st[name]["max_per_call"] > 1, name      # over its budget
    keys = {f.key() for f in rep.allowed()}
    assert {"host-sync ShardedFlatAFLI.start_reflow ops.py:82",
            "host-sync ShardedFlatAFLI.start_reshard serving_state.py:112"
            } <= keys
    assert all(f.entry in names for f in rep.allowed())


def test_recorder_counts_a_fetch_once_and_nothing_in_plain_versions():
    entry = contracts.EntryPoint("probe", "repro_torch.analysis.fixtures",
                                 "host_fetch_serve", budget=0)
    rep = tfind.Report()
    rec = contracts.HostSyncRecorder("cpu")
    with rec.install():
        call = rec.enter(entry, "host_fetch", 0, None)
        tfix.host_fetch_serve(torch.ones(3))
        rec.leave(call, rep)
        call = rec.enter(entry, "plain", 0, None)
        tfix.batch_loop_plain(torch.ones(3), torch.ones(4))
        bool(tfix.lane_cast_plain(torch.ones(2, dtype=torch.int32),
                                  torch.ones(2, dtype=torch.int32)).any())
        rec.leave(call, rep)
    # z.cpu().numpy() counts once, the probe's result moved back once; a
    # sync outside the package (this test's bool) is not sited
    assert rec.stats["host_fetch"]["syncs"] == 2
    assert rec.stats["plain"]["syncs"] == 0
    # both on the fixture's one line: one finding, two syncs at the site
    assert [f.details["at_site"] for f in rep.blocking()] == [2]
    assert torch.Tensor.cpu is torch._C.TensorBase.cpu   # patches undone


@pytest.mark.parametrize("world,charged", [("cpu", False), ("cuda", True)])
def test_plain_versions_are_exempt_only_on_the_cpu(monkeypatch, world,
                                                   charged):
    """A sync under a ``*_plain`` function is the CPU's stand-in for
    device work; on the card a plain version is a fallback the port
    forbids, so a sync there (or a debug-mode warning) counts at its
    site."""
    entry = contracts.EntryPoint("probe", "repro_torch.analysis.fixtures",
                                 "batch_loop", budget=0)
    rec = contracts.HostSyncRecorder(world)
    real_sum = torch.Tensor.sum

    def warn_in_plain(self, *a, **k):
        rec._charge("warned")
        return real_sum(self, *a, **k)

    call = rec.enter(entry, "probe", 0, None)
    monkeypatch.setattr(torch.Tensor, "sum", warn_in_plain)
    tfix.batch_loop_plain(torch.ones(3), torch.ones(4))
    monkeypatch.undo()
    rec.leave(call, tfind.Report())
    sites = list(call.warned)
    if charged:
        [site] = sites
        assert "(pool[None, :] <= q[:, None]).sum(" in _source_line(site)
    else:
        assert sites == []


def test_an_entry_the_world_never_dispatches_is_a_finding():
    ghost = contracts.EntryPoint("ghost", "repro_torch.kernels.ops",
                                 "index_probe", budget=0)
    rep = tfind.Report()
    contracts.run_host_sync_checks(rep, "cpu", entries=(ghost,),
                                   world=lambda: None)
    [f] = rep.blocking()
    assert "never dispatched" in f.message and f.location.endswith(
        f"ops.py:{f.location.rsplit(':', 1)[1]}")


def test_alloc_contract_clean_on_the_real_tree_cpu():
    rep = tfind.Report()
    out = alloc.run_alloc_checks(rep, device="cpu")
    assert rep.ok, rep.render()
    assert {e for e, _ in rep.checked} >= {
        "DeviceTier[run]", "DeviceTier[delta]", "DeviceTier[scan]",
        "DeviceTier[router]", "build.load"}
    # the streamed sweeps reuse the router between scan-pool uploads
    assert out["router_builds"] == out["router_keys"] >= 2
    assert out["stream_reuses"] > 0


def test_tier_allocations_along_the_lattice_equal_the_jax_tiers():
    """Each tier's capacity sequence along the lattice drive equals the
    JAX ``DeviceTier``'s along the same drive.  (The port's drive also
    reads on the streamed rung, which allocates no tier.)"""
    import repro.core.serving_state as jss
    from repro.analysis.retrace import drive_lattice as jax_drive

    seen = []
    real = jss.DeviceTier._alloc

    def spy(self, cap, *a, **k):
        seen.append((id(self), int(cap)))
        return real(self, cap, *a, **k)

    jss.DeviceTier._alloc = spy
    try:
        _declared, jidx = jax_drive()
    finally:
        jss.DeviceTier._alloc = real
    slot = {id(getattr(jidx._serving, s)): s for s in alloc.SLOTS}
    jax_caps = {s: [c for i, c in seen if slot.get(i) == s]
                for s in alloc.SLOTS}
    port = alloc.drive_lattice(device="cpu")
    port_caps = {s: [c for c, _site in port["allocs"][s]]
                 for s in alloc.SLOTS}
    assert port_caps == jax_caps
    assert port_caps == {"run": [1024], "delta": [1024], "scan": [2048]}
    pst = port["index"].stats()["serving"]
    for s in alloc.SLOTS:
        assert pst[f"{s}_capacity"] == getattr(jidx._serving, s).capacity


def test_smem_proof_grid_and_documented_cliff():
    rep = tfind.Report()
    out = smem.run_smem_checks(rep)
    assert rep.ok, rep.render()
    cliff = [f for f in rep.advisory()
             if f.entry == "streamed_lookup:2^26"]
    assert cliff and "router staged in part" in cliff[0].message
    assert cliff[0].details["cliff_rows"] == out["router_cliff_rows"]
    assert not [f for f in rep.advisory() if f.entry.endswith("2^25")]
    assert out["streamed_lookup:2^26"] == smem.SMEM_LIMIT
    # a limit below the scan kernel's 16-step plan is an error
    bad = tfind.Report()
    smem.run_smem_checks(bad, limit=40_000)
    assert any(f.entry.startswith("mamba_scan") for f in bad.blocking())


def test_smem_grid_covers_every_family_decode_shape():
    """Each architecture whose decode attention takes the kernel route
    has its (head dim, q heads per kv head) in the grid, for every cache
    dtype, within the limit."""
    from repro_torch.configs import arch_names, get_config
    from repro_torch.models.attention import decode_route

    out = smem.run_smem_checks(tfind.Report())
    shapes = set()
    for arch in arch_names():
        a = get_config(arch).attn
        if a is not None and decode_route(a) == "kernel":
            shapes.add((a.head_dim, a.n_heads // a.kv_heads))
    assert shapes == set(smem.DECODE_SHAPES)
    for d, g in shapes:
        for dt in ("float32", "bfloat16", "float16"):
            assert out[f"flash_decode:D={d}:G={g}:{dt}"] <= smem.SMEM_LIMIT


def _c_streamed(cap, optin, static=4096):
    """csrc/streamed_lookup.cu's launcher and streamed_lookup.py:237-283,
    line by line: the router entries staged and the dynamic bytes."""
    need = -(-cap // 1024) + 1
    n_slices = max(cap // 1024, 1)
    router_len = ((n_slices + 1 + 127) // 128) * 128
    r_smem = min(-(-need // 4) * 4, router_len)       # wrapper
    fit = ((optin - static) // 4) & ~3                # launcher
    if r_smem > fit:
        r_smem = fit
    return 4 * r_smem, r_smem, need


def _c_mamba(n):
    """mamba_scan.cu launch<G, NPL>: bytes from the wrapper's plan."""
    from repro_torch.kernels.mamba_scan import scan_plan

    p = scan_plan(1, 1, 1, n)
    return 4 * (2 * (2 * p.chunk * 32 + 2 * p.chunk * n)
                + p.chunk * 32 * p.lanes), p


def _c_layout(d, elem, vec):
    """flash_decode.cu Layout(D, elem, vec).total, C integer semantics."""
    rb = d * elem
    nch = (rb + 15) // 16
    rsk = 16 * (nch | 1)
    rsv = 16 * nch
    stage = 16 * (rsk + rsv)
    nw = (96 * 1024) // (2 * stage)
    nw = 1 if nw < 1 else (4 if nw > 4 else nw)
    dp = nch * vec
    q = nw * 2 * stage
    pw = q + 4 * 8 * dp
    ml = pw + 4 * 4 * 8 * 16
    return ml + 4 * 4 * 8 * 2


@pytest.mark.parametrize("cap", [1, 4, 1023, 1024, 1025, 1 << 17, 1 << 20,
                                 1 << 25, (1 << 25) + 1,
                                 smem.router_cliff_rows() - 1024,
                                 smem.router_cliff_rows() - 1,
                                 smem.router_cliff_rows(), 1 << 26])
def test_smem_model_holds_to_the_c_launchers_arithmetic(cap):
    assert smem.streamed_router(cap) == _c_streamed(cap, smem.SMEM_LIMIT)
    dyn, staged, need = smem.streamed_router(cap)
    at_cliff = cap >= smem.router_cliff_rows()
    assert (staged < need) == at_cliff
    assert smem.model("streamed_lookup_kernel", capacity=cap) == 4096 + dyn


def test_smem_model_holds_for_every_scan_state_and_decode_head_dim():
    for n in range(1, 129):
        bytes_, plan = _c_mamba(n)
        assert smem.mamba_bytes(n) == (bytes_, plan.chunk)
        assert plan.smem_bytes == bytes_                 # the wrapper agrees
        assert smem.model("mamba_scan_kernel", n=n) <= smem.SMEM_LIMIT
    for d in range(1, 257):
        for dtype, (elem, vec) in (("float32", (4, 4)), ("bfloat16", (2, 8)),
                                   ("float16", (2, 8))):
            assert smem.decode_bytes(d, dtype) == _c_layout(d, elem, vec)
            assert smem.decode_bytes(d, dtype) <= smem.SMEM_LIMIT


def test_static_smem_checked_against_a_ptxas_log():
    log = ("ptxas info    : Compiling entry function "
           "'_Z19fused_lookup_kernelILi0ELi8EEv10LookupArgs8NFParams' for "
           "'sm_90a'\nptxas info    : Used 32 registers, 2048 bytes smem, "
           "400 bytes cmem[0]\nptxas info    : Compiling entry function "
           "'_Z17range_scan_kernelILi0EEv8ScanArgs8NFParams' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, 5000 bytes smem\n")
    rep = tfind.Report()
    rows = smem.check_static_against_ptxas(rep, {"x": log})
    assert [r["ptxas"] for r in rows] == [2048, 5000]
    [f] = rep.blocking()
    assert f.contract == "smem:model-drift" and f.entry == "range_scan_kernel"
    # a modelled kernel that no log records went unchecked: an error
    rep = tfind.Report()
    smem.check_static_against_ptxas(rep, {"x": log}, expect=smem.STATIC)
    missing = {f.entry for f in rep.blocking() if f.contract == "smem"}
    assert missing == set(smem.STATIC) - {"fused_lookup_kernel",
                                          "range_scan_kernel"}


# ---------------------------------------------------------- build, CLI
def test_fixtures_build_beside_the_serving_kernels_with_their_hashes_kept():
    import hashlib

    assert build.source_path("fixtures") == FIXTURES_CU
    for name in build.SOURCES:
        h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        h.update((build.CSRC / f"{name}.cu").read_bytes())
        for hdr in sorted(build.CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
        assert build._lib_path(name).name == \
            f"lib{name}-{h.hexdigest()[:16]}.so"
    assert set(contracts.kernel_lines()) >= {
        "clip_gather_kernel", "lane_cast_kernel", "batch_loop_kernel",
        "f64_upcast_kernel", "fused_lookup_kernel", "streamed_lookup_kernel",
        "decode_split_kernel", "mamba_scan_kernel", "index_probe_kernel"}


def test_a_library_without_its_ptxas_log_is_built_again(monkeypatch,
                                                        tmp_path):
    """A library left in ``build/`` without its ptxas log (built before
    the logs were kept) is compiled again, so every library that
    ``build_all`` returns has its log."""
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_COUNTS", {
        "built": collections.Counter(), "loaded": collections.Counter()})
    names = (*build.SOURCES, *build.EXTRA_SOURCES)
    for name in names:
        path = build._lib_path(name)
        path.write_bytes(b"so")
        if name != "range_scan":
            path.with_suffix(".log").write_text(f"ptxas info : {name}")
    ran = []

    class FakeNvcc:
        def __init__(self, cmd, **_kw):
            ran.append(Path(cmd[-1]).stem)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"new so")
            self.returncode = 0

        def communicate(self):
            return "ptxas info : rebuilt range_scan", None

    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    out = build.build_all()
    assert ran == ["range_scan"]
    assert out["range_scan"]["built"] and out["range_scan"]["log"] == \
        "ptxas info : rebuilt range_scan"
    assert build._lib_path("range_scan").read_bytes() == b"new so"
    assert build._lib_path("range_scan").with_suffix(".log").exists()
    assert all(out[n]["log"] for n in names)
    assert not any(out[n]["built"] for n in names if n != "range_scan")
    assert build.load_counts()["built"] == {"range_scan": 1}
    # now every library has its log: nothing is compiled again
    ran.clear()
    build.build_all()
    assert ran == []


def test_fixture_records_name_the_jax_defs():
    """Each fixture's ``replaces`` is the ``def`` (or ``class``) of the
    JAX fixture it ports, and each kernel fixture's ``kernel`` is a
    ``__global__`` of ``fixtures.cu``."""
    globals_ = contracts.kernel_lines()
    for name, f in tfix.FIXTURES.items():
        path, _, line = f.replaces.rpartition(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert re.match(r"(def|class) \w+", text), (name, text)
        if f.kernel:
            assert globals_[f.kernel].startswith("fixtures.cu:")
            assert f.call in tfix.KERNELS and f.needs_card
        else:
            assert f.call is None and not f.needs_card
    assert set(tfix.launch_counts()) == {k.__name__ for k in tfix.KERNELS}


def test_cli_json_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--device", "cpu", "--json"])
    payload = json.loads(buf.getvalue())
    assert rc == 0 and payload["ok"] and not payload["blocking"]
    facts = payload["facts"]
    assert facts["device"] == "cpu"
    assert any("debug mode" in w for w in facts["not_run"])
    assert any("PTX" in w for w in facts["not_run"])
    assert set(facts["syncs"]) >= {e.name for e in contracts.ENTRY_POINTS}
    assert facts["alloc"]["allocs"] == {"run": [1024], "delta": [1024],
                                        "scan": [2048]}
    keys = {f["key"] for f in payload["findings"]}
    assert "host-sync DeviceTier.refresh serving_state.py:112" in keys


def test_cli_without_a_card_raises_and_rejects_unknown_contracts():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
    assert main(["--device", "cpu", "--contracts", "vmem"]) == 2
