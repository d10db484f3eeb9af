"""The port's serving CLI (``repro_torch.launch.serve_events``) against the
reference's (``repro.launch.serve_events``): ``main(argv)`` of both at
``--sessions 2 --duration-us 6000 --dvfs`` under every ``--policy`` with
the dense readout, and compact under ``static`` and ``ladder``; the
reference on ``--backend jnp``, the port on ``fused`` (and ``torch``,
``nmc``, ``batched`` for the static run), ``--device cpu``.  Equal: the
``--metrics-out`` JSONL records apart from wall-clock keys (``t_wall`` and
``obs.schema.WALL_TIME_KEYS``, through ``obs.schema.steady_record``), the
``[backpressure]`` / ``[migration]`` / ``[ladder]`` log lines, the
per-lane report lines (bucket, qos, tier, migrations, migration log) and
the compiled executors."""
import contextlib
import functools
import io
import re

import pytest

torch = pytest.importorskip("torch")

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro.launch import serve_events as j_cli  # noqa: E402
from repro_torch.launch import serve_events as t_cli  # noqa: E402
from repro_torch.obs import read_jsonl  # noqa: E402
from repro_torch.obs.schema import steady_record  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = ["--sessions", "2", "--duration-us", "6000", "--dvfs"]
# Flags under which each policy acts at this size: the adaptive lanes
# migrate, the ladder climbs and actuates a tier, pack moves a lane.
RUNS = {
    "static": [],
    "static_compact": ["--readout", "compact"],
    "adaptive": ["--policy", "adaptive", "--buckets", "64,256,1024",
                 "--connect-chunk", "64", "--migrate-patience", "1"],
    "ladder": ["--policy", "ladder", "--burst-factor", "2",
               "--qos", "standard,premium", "--slab", "1024"],
    "ladder_compact": ["--policy", "ladder", "--burst-factor", "2",
                       "--qos", "standard,premium", "--slab", "1024",
                       "--readout", "compact"],
    "pack": ["--policy", "pack", "--buckets", "64,256,1024"],
}
LANE = re.compile(r"^  lane (\d+): bucket (\d+), qos (\S+) \(tier (\d+)\), "
                  r"rate est .*?, (\d+) migration\(s\) (.*)$")
EVENT = re.compile(r"^  \[(backpressure|migration|ladder)\] ")


def _run(main, argv, path):
    """``main(argv)`` writing its JSONL trail to ``path``; returns the
    steady records, the event log lines, the parsed lane lines and the
    compiled-executor line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dt, lat = main([*argv, "--metrics-out", str(path)])
    assert dt > 0 and len(lat) > 0
    lines = buf.getvalue().splitlines()
    return dict(
        records=read_jsonl(path),
        events=[ln for ln in lines if EVENT.match(ln)],
        lanes=[LANE.match(ln).groups() for ln in lines if LANE.match(ln)],
        compiled=[ln for ln in lines if ln.startswith("compiled executors")],
    )


@functools.lru_cache(maxsize=None)
def _reference(name, tmp):
    return _run(j_cli.main, [*BASE, *RUNS[name], "--backend", "jnp"],
                f"{tmp}/ref_{name}.jsonl")


def _assert_same(got, want):
    assert [steady_record(r) for r in got["records"]] == \
        [steady_record(r) for r in want["records"]]
    assert got["events"] == want["events"]
    assert got["lanes"] == want["lanes"]
    assert len(got["lanes"]) == 2
    assert got["compiled"] == want["compiled"]
    assert len(got["compiled"]) == 1


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli_ref"))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_matches_reference(name, ref_dir, tmp_path):
    want = _reference(name, ref_dir)
    got = _run(t_cli.main, [*BASE, *RUNS[name], "--backend", "fused",
                            "--device", "cpu"], tmp_path / "port.jsonl")
    _assert_same(got, want)


@pytest.mark.parametrize("backend", ["torch", "nmc", "batched"])
def test_cli_backends_match_reference(backend, ref_dir, tmp_path):
    """The reference pins its backends bit for bit, so every port backend
    equals the reference's ``jnp`` run."""
    want = _reference("static", ref_dir)
    got = _run(t_cli.main, [*BASE, "--backend", backend, "--device", "cpu"],
               tmp_path / "port.jsonl")
    _assert_same(got, want)


def test_policies_act_at_this_size(ref_dir):
    """The runs compared above are not idle: the adaptive lanes migrate,
    the ladder climbs and moves a tier, pack moves a lane."""
    lanes = {n: _reference(n, ref_dir)["lanes"] for n in RUNS}
    assert all(int(m) > 0 for *_, m, _log in lanes["adaptive"])
    assert any(int(m) > 0 for *_, m, _log in lanes["pack"])
    assert any(tier != "0" for _l, _b, _q, tier, *_ in lanes["ladder"])
    events = _reference("ladder", ref_dir)["events"]
    assert any("level climbed" in e for e in events)


def test_two_reference_runs_differ_only_in_wall_clocks(ref_dir, tmp_path):
    """The comparison leaves out only wall clocks: two runs of the
    reference at the same flags (async drain) have equal steady records,
    and their ``t_wall`` differs."""
    first = _reference("ladder", ref_dir)
    again = _run(j_cli.main, [*BASE, *RUNS["ladder"], "--backend", "jnp"],
                 tmp_path / "again.jsonl")
    _assert_same(again, first)
    assert again["records"][-1]["t_wall"] != first["records"][-1]["t_wall"]


def test_backend_choices_are_the_ports(capsys):
    with pytest.raises(SystemExit):
        t_cli.main([*BASE, "--backend", "jnp", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "invalid choice: 'jnp'" in err
    listed = err.split("choose from", 1)[1]
    for name in ("fused", "torch", "nmc", "batched"):
        assert name in listed


@pytest.mark.skipif(torch.cuda.is_available(), reason="host has CUDA")
def test_cuda_default_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main([*BASE])
