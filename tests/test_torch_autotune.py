"""The port's autotuner, tuning refs and store on the CPU.

Mirrors tests/test_autotune.py case for case with `--device cpu` (the
plain versions timed as a proxy), then checks what the port adds: the
winner is a `tile_p`, the env fingerprint names the device (a CPU
proxy's tile never lands on a card's ref), the spec dicts are the JAX
package's (one workload, one spec fingerprint in both packages), and the
K2 and K3 wrappers launch with a stored `tile_p` on a store hit.

The exit contract (the ckpt_fsck/fleetctl/servectl convention):
  0  every workload already tuned (pure store hit)
  1  at least one sweep ran (or would run, under --dry-run)
  2  a sweep failed or the store is unusable
  64 usage errors
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.ops import cell_kernels as jax_ck
from adanet_tpu.ops import sepconv_kernels as jax_sk
from adanet_tpu_torch.ops import cell_kernels as ck
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.ops import tuning
from adanet_tpu_torch.store import ArtifactStore, keys
from adanet_tpu_torch.tools import autotune

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_tuning_state(monkeypatch):
    monkeypatch.delenv("ADANET_TUNE_STORE", raising=False)
    tuning.clear_cache()
    tuning.set_default_store(None)
    yield
    tuning.clear_cache()
    tuning.set_default_store(None)


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA environment as the fingerprint sees it, without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(keys, "_env_fp_cache", {})


def _run(capsys, *argv):
    rc = autotune.main(list(argv))
    out = capsys.readouterr().out
    return rc, out


def test_usage_error_exits_64(capsys):
    with pytest.raises(SystemExit) as e:
        autotune.main([])  # --store is required
    assert e.value.code == 64
    with pytest.raises(SystemExit) as e:
        autotune.main(["--store", "x", "--kernel", "nonsense"])
    assert e.value.code == 64
    with pytest.raises(SystemExit) as e:
        autotune.main(["--store", "x", "--device", "tpu"])
    assert e.value.code == 64


def test_unusable_store_exits_2(tmp_path, capsys):
    path = tmp_path / "not_a_dir"
    path.write_text("a file where the store root should be")
    rc = autotune.main(["--store", str(path), "--preset", "tiny", "--device", "cpu"])
    assert rc == 2


def test_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.main(["--store", str(tmp_path / "store"), "--preset", "tiny"])


def test_first_run_sweeps_second_run_pure_store_hit(tmp_path, capsys):
    store = str(tmp_path / "store")
    argv = ["--store", store, "--preset", "tiny", "--device", "cpu", "--json"]

    rc1, out1 = _run(capsys, *argv)
    report1 = json.loads(out1)
    assert rc1 == 1, report1
    assert report1["exit_code"] == 1
    assert report1["searched"] == 2  # one sepconv + one cell workload
    assert report1["hits"] == 0
    assert report1["failed"] == 0
    assert report1["device"] == "cpu"
    for entry in report1["workloads"]:
        assert entry["status"] == "tuned", entry
        # The winner is one of the swept tiles: a pixel count, or AUTO
        # (0, the planned tiles), which both kernels' sweeps list first.
        assert entry["winner"]["tile_p"] in [c["tile_p"] for c in entry["candidates"]]
        assert entry["candidates"][0]["tile_p"] == ck.AUTO == sk.AUTO
        assert entry["winner"]["tile_p"] >= ck.AUTO
        assert entry["winner"]["device"] == "cpu"
        assert entry["ref"].startswith(entry["kernel"] + "-")
        assert entry["ref"].endswith(keys.env_fingerprint("cpu"))

    # The second invocation must hit the STORE, not the in-process memo.
    tuning.clear_cache()
    rc2, out2 = _run(capsys, *argv)
    report2 = json.loads(out2)
    assert rc2 == 0, report2
    assert report2["searched"] == 0
    assert report2["hits"] == 2
    assert report2["failed"] == 0
    for entry, tuned in zip(report2["workloads"], report1["workloads"]):
        assert entry["status"] == "hit", entry
        assert entry["winner"]["tile_p"] == tuned["winner"]["tile_p"]


def test_dry_run_reports_pending_without_writing(tmp_path, capsys):
    store = str(tmp_path / "store")
    argv = ["--store", store, "--preset", "tiny", "--device", "cpu", "--json"]

    rc, out = _run(capsys, *argv, "--dry-run")
    report = json.loads(out)
    assert rc == 1, report
    assert report["pending"] == 2
    assert report["searched"] == 0
    for entry in report["workloads"]:
        assert entry["status"] == "pending"
        assert entry["candidates"], entry

    # Nothing was published: a real run still has everything to do.
    rc, out = _run(capsys, *argv)
    assert rc == 1
    assert json.loads(out)["searched"] == 2

    # A dry run over a fully-tuned store is clean (exit 0).
    tuning.clear_cache()
    rc, out = _run(capsys, *argv, "--dry-run")
    report = json.loads(out)
    assert rc == 0, report
    assert report["hits"] == 2 and report["pending"] == 0


def test_kernel_filter_tunes_one_family(tmp_path, capsys):
    store = str(tmp_path / "store")
    rc, out = _run(
        capsys,
        "--store", store, "--preset", "tiny", "--device", "cpu", "--json",
        "--kernel", "sepconv",
    )
    report = json.loads(out)
    assert rc == 1
    assert [e["kernel"] for e in report["workloads"]] == ["sepconv"]


def test_text_report_names_the_tile(tmp_path, capsys):
    rc, out = _run(capsys, "--store", str(tmp_path / "store"), "--preset", "tiny", "--device", "cpu")
    assert rc == 1
    assert out.count("tuned (tile_p=") == 2
    assert out.strip().splitlines()[-1] == "searched=2 hits=0 pending=0 failed=0"


def test_sweep_requires_a_survivor():
    """tuning.sweep: every candidate failing is unrecoverable (exit 2
    at the CLI); partial failures are recorded but tolerated."""

    def always_broken(cand):
        raise RuntimeError("no backend")

    with pytest.raises(RuntimeError):
        tuning.sweep(always_broken, [{"tile_p": 16}, {"tile_p": 32}])

    def half_broken(cand):
        if cand["tile_p"] == 32:
            raise RuntimeError("bad tile")

    synced = []
    winner, results = tuning.sweep(
        half_broken, [{"tile_p": 16}, {"tile_p": 32}], synchronize=lambda: synced.append(1)
    )
    assert winner["tile_p"] == 16
    by_tile = {r["tile_p"]: r for r in results}
    assert "error" in by_tile[32]
    assert by_tile[16]["secs"] >= 0
    # The clock waits for the queue: once after the warmup, once per timed run.
    assert len(synced) == 3


def test_sweep_ranks_by_the_timer_when_given():
    """On the card the sweep times with CUDA events (`timer`) instead of
    the host clock: the timer's seconds rank the candidates, warmup
    excluded."""
    calls = []
    seconds = {16: 3e-4, 32: 1e-4, 0: 2e-4}

    def timer(fn):
        fn()
        return seconds[calls[-1]]

    def clock():
        raise AssertionError("the host clock was read")

    winner, results = tuning.sweep(
        lambda cand: calls.append(cand["tile_p"]), [{"tile_p": t} for t in (0, 16, 32)],
        repeats=2, clock=clock, timer=timer,
    )
    assert winner == {"tile_p": 32, "secs": 1e-4}
    assert [r["secs"] for r in results] == [2e-4, 3e-4, 1e-4]
    assert calls == [0, 0, 0, 16, 16, 16, 32, 32, 32]  # warmup + 2 timed each


def test_candidate_tile_sizes_respect_budget():
    # 100 pixels: tiles start at 128, the first power of two covering
    # them. At 4 bytes a pixel plus 100 fixed against a 400-byte budget,
    # 64 needs 356 <= 400 (fits); 128 needs 612 (does not).
    assert tuning.candidate_tile_sizes(100, 4, 100, 400, smallest=16) == [64, 32, 16]
    # A budget smaller than the smallest tile still yields it rather
    # than an empty sweep.
    assert tuning.candidate_tile_sizes(100, 1000, 0, 850, smallest=16) == [16]
    assert tuning.candidate_tile_sizes(0, 4, 0, 400) == []
    # The kernels' candidates fit the card's 227 KB of shared memory: at
    # each K3 candidate every launch of the cell's schedule does, and its
    # separable layers keep all F channels in a block up to that tile.
    for tile in ck.tile_candidates(64, 32, 32, 64, ck.REDUCTION_CELL):
        sched = ck.cell_schedule((64, 32, 32, 32), (64, 32, 32, 32), torch.float32, 64,
                                 ck.REDUCTION_CELL, True, tile, 132)
        for step in sched.steps:
            assert step.fields.get("smem", 0) <= sk.MAX_SHARED_BYTES
            if step.kind == "sep_layer" and tile != ck.AUTO:
                assert step.fields["th"] * step.fields["tw"] <= tile and step.fields["tf"] == 64
    for tile in sk.tile_candidates(32, 32, 32, 32, 5, 1):
        assert sk.tiles(32, 32, 5, tile) == (tile, 32)


def test_record_is_set_once_and_losers_adopt_winner(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    spec = {"x_shape": [4, 8, 8, 8], "dtype": "float32"}
    first = tuning.record(store, "sepconv", spec, {"tile_p": 64}, [{"tile_p": 64, "secs": 1}], "cpu")
    assert first["meta"]["winner"]["tile_p"] == 64
    # A racing second publisher loses the ref claim and ADOPTS the
    # winner already in the store.
    adopted = tuning.record(store, "sepconv", spec, {"tile_p": 32}, [{"tile_p": 32, "secs": 2}], "cpu")
    assert adopted["meta"]["winner"]["tile_p"] == 64
    tuning.clear_cache()
    assert tuning.lookup("sepconv", spec, store=store, device="cpu")["tile_p"] == 64


def test_lookup_reads_a_recorded_ref(tmp_path, monkeypatch):
    root = str(tmp_path / "store")
    spec = {"x_shape": [2, 8, 8, 8], "dtype": "bfloat16"}
    tuning.record(ArtifactStore(root), "cell", spec, {"tile_p": 128, "device": "cpu"}, device="cpu")
    tuning.clear_cache()
    # No store registered and an empty cache: a miss, before any read.
    assert tuning.lookup("cell", spec, device="cpu") is None
    # Through the environment variable, then through the default store.
    monkeypatch.setenv("ADANET_TUNE_STORE", root)
    assert tuning.lookup("cell", spec, device="cpu") == {"tile_p": 128, "device": "cpu"}
    monkeypatch.delenv("ADANET_TUNE_STORE")
    tuning.clear_cache()
    tuning.set_default_store(ArtifactStore(root))
    assert tuning.lookup("cell", spec, device="cpu")["tile_p"] == 128
    assert tuning.lookup("cell", dict(spec, dtype="float32"), device="cpu") is None
    assert tuning.lookup("sepconv", spec, device="cpu") is None


def test_malformed_ref_reads_as_a_miss(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    spec = {"x_shape": [2, 8, 8, 8]}
    store.put_ref(tuning.TUNE_REF_KIND, tuning.tune_ref_name("cell", spec, "cpu"), {}, meta={"winner": 7})
    assert tuning.lookup("cell", spec, store=store, device="cpu") is None


def test_env_fingerprint_names_the_device(fake_card, tmp_path):
    cpu = keys.env_fingerprint("cpu")
    card = keys.env_fingerprint("cuda")
    assert cpu != card and len(card) == 64
    assert keys.env_fingerprint() == card  # CUDA available: the default
    # A tile tuned on the (faked) card is not a CPU proxy's, and back.
    store = ArtifactStore(str(tmp_path / "store"))
    spec = {"x_shape": [2, 8, 8, 8]}
    assert tuning.tune_ref_name("cell", spec, "cuda") != tuning.tune_ref_name("cell", spec, "cpu")
    tuning.record(store, "cell", spec, {"tile_p": 256, "device": "cuda"}, device="cuda")
    tuning.clear_cache()
    assert tuning.lookup("cell", spec, store=store, device="cpu") is None
    assert tuning.lookup("cell", spec, store=store, device="cuda")["tile_p"] == 256


def test_tune_specs_are_the_jax_packages():
    """One workload has one spec fingerprint in both packages."""
    x = jnp.zeros((4, 8, 8, 8), jnp.float32)
    want = jax_sk._sepconv_tune_spec(x, jnp.zeros((3, 3, 1, 8)), jnp.zeros((1, 1, 8, 16)), 2)
    assert sk.tune_spec((4, 8, 8, 8), torch.float32, 3, 16, 2) == want
    prev = jnp.zeros((2, 8, 8, 12), jnp.bfloat16)
    cur = jnp.zeros((2, 8, 8, 6), jnp.bfloat16)
    params = {"begin": {"w": jnp.zeros((6, 8))}}
    want = jax_ck._tune_spec(prev, cur, params, jax_ck.REDUCTION_CELL)
    got = ck.tune_spec((2, 8, 8, 12), (2, 8, 8, 6), torch.bfloat16, 8, ck.REDUCTION_CELL)
    assert got == want
    assert keys.spec_fingerprint(got) == keys.spec_fingerprint(want)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_tuned_tile_is_consulted(tmp_path, fake_card, device):
    """On a store hit the K2 and K3 wrappers' tile selection returns the
    stored `tile_p` for their device (the port's counterpart of
    test_tuned_block_size_is_consulted); without one, the heuristic."""
    store = ArtifactStore(str(tmp_path / "store"))
    x_shape, c, f, k, stride = (4, 8, 8, 8), 8, 16, 3, 1
    assert sk.select_tiles(x_shape, torch.float32, c, f, k, stride, device) == sk.tiles(c, f, k)
    prev_shape, cur_shape = (2, 8, 8, 6), (2, 8, 8, 8)
    spec = ck.NORMAL_CELL
    # Without a winner K3 plans its tiles itself (AUTO), as K2 does.
    assert ck.DEFAULT_TILE_P == ck.AUTO == sk.AUTO
    assert ck.select_tile_p(prev_shape, cur_shape, torch.bfloat16, 4, spec, device) == ck.DEFAULT_TILE_P

    tuning.record(store, "sepconv", sk.tune_spec(x_shape, torch.float32, k, f, stride),
                  {"tile_p": 16, "device": device}, device=device)
    tuning.record(store, "cell", ck.tune_spec(prev_shape, cur_shape, torch.bfloat16, 4, spec),
                  {"tile_p": 256, "device": device}, device=device)
    tuning.clear_cache()
    tuning.set_default_store(store)
    assert sk.select_tiles(x_shape, torch.float32, c, f, k, stride, device) == (16, f)
    assert ck.select_tile_p(prev_shape, cur_shape, torch.bfloat16, 4, spec, device) == 256
    # Another dtype is another workload; another device another env.
    assert ck.select_tile_p(prev_shape, cur_shape, torch.float32, 4, spec, device) == ck.DEFAULT_TILE_P
    other = "cpu" if device == "cuda" else "cuda"
    assert ck.select_tile_p(prev_shape, cur_shape, torch.bfloat16, 4, spec, other) == ck.DEFAULT_TILE_P

    # The CPU wrappers still take the plain versions (no tile, no launch).
    before = (sk.fused_sep_conv.launches, ck.fused_cell.launches)
    rng = np.random.RandomState(0)
    out = sk.fused_sep_conv(torch.from_numpy(rng.randn(*x_shape).astype(np.float32)),
                            torch.randn(c, 1, k, k), torch.randn(f, c, 1, 1), stride)
    assert tuple(out.shape) == (4, 8, 8, f)
    assert (sk.fused_sep_conv.launches, ck.fused_cell.launches) == before


@pytest.mark.parametrize("preset", ["tiny", "cifar"])
def test_sepconv_sweep_lists_auto_first(preset):
    """K2's sweep, like K3's, starts with AUTO, the tile K2 plans without
    a store, so that a stored winner is never slower than no tuning."""
    for workload in autotune._sepconv_workloads(preset):
        _, candidates, _ = autotune._tune_sepconv(workload, torch.device("cpu"))
        assert candidates[0] == {"tile_p": sk.AUTO}
        assert all(c["tile_p"] > 0 for c in candidates[1:])


def test_auto_timed_fastest_is_stored_and_launches_the_plan(tmp_path, capsys, monkeypatch):
    """When AUTO is timed fastest (a stubbed timer), the K2 sweep stores
    AUTO, and the wrapper then launches the plan it makes without a store."""
    running = []
    tune_sepconv = autotune._tune_sepconv

    def recording(workload, device):
        spec, candidates, run = tune_sepconv(workload, device)
        return spec, candidates, lambda cand: running.append(cand["tile_p"]) or run(cand)

    def timer(fn):
        fn()
        return 1e-4 if running[-1] == sk.AUTO else 2e-4

    monkeypatch.setattr(autotune, "_tune_sepconv", recording)
    sweep = tuning.sweep
    monkeypatch.setattr(tuning, "sweep", lambda *args, **kwargs: sweep(*args, **dict(kwargs, timer=timer)))
    monkeypatch.setattr(sk, "_sm_count", lambda device: 132)
    store = str(tmp_path / "store")
    rc, out = _run(capsys, "--store", store, "--preset", "tiny", "--device", "cpu", "--kernel", "sepconv", "--json")
    report = json.loads(out)
    assert rc == 1, report
    (entry,) = report["workloads"]
    assert entry["winner"]["tile_p"] == sk.AUTO
    assert sk.AUTO in running and len(set(running)) == len(entry["candidates"])

    tuning.clear_cache()
    tuning.set_default_store(ArtifactStore(store))
    (b, h, w, c), k, f, stride = entry["workload"]["shape"], 3, 8, 1
    assert (entry["workload"]["kernel"], entry["workload"]["filters"]) == (k, f)
    stored = tuning.lookup("sepconv", sk.tune_spec((b, h, w, c), torch.float32, k, f, stride), device="cpu")
    assert stored["tile_p"] == sk.AUTO
    x = torch.zeros(b, h, w, c)
    plan = sk.plan_for(x, torch.zeros(c, 1, k, k), torch.zeros(f, c, 1, 1), stride)
    assert plan.tile == sk.tiles(c, f, k, sk.AUTO)
    assert plan.fields == sk.launch_plan(x.shape, torch.float32, f, k, stride, sk.AUTO, 132).fields
