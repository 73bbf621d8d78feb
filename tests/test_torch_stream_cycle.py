"""The port's streamed cycle (`run_cycle(stream_chunk=4)`, through
`parallel.pipeline.streamed_profile_solve` and
`Scheduler.attribution_codes`) against JAX `run_cycle(stream_chunk=4)`,
cycle by cycle, on the scripts of `tests/test_torch_cycle.py`.

After every cycle the reports and the store's bookkeeping must be
identical (tolerance 0, insertion order included), and in every cycle
with a batch both packages' streamed solve must have served the cycle:
neither may fall back to the sequential solve. The scripts are divided
between this file and `tests/test_torch_pipeline.py` (`STREAMED_HERE`
names this file's) so that neither file runs much over a minute and a
half serially; every script of `SCRIPTS` runs in one of the two.

The `cuda`-marked test runs the streamed cycle on the card and on the CPU
(`python -m pytest tests/test_torch_stream_cycle.py -m cuda`); it needs
no JAX."""

from types import SimpleNamespace

import pytest
import torch

import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
from scheduler_plugins_tpu_torch.state import cluster as port_store
from test_torch_cycle import (
    JAX,
    PORT,
    SCRIPTS,
    churn_script,
    report_diff,
    smoke_script,
    store_diff,
)

try:
    import scheduler_plugins_tpu.parallel.pipeline as jax_pipeline
except ImportError:
    jax_pipeline = None

CHUNK = 4

#: the scripts this file streams; `tests/test_torch_pipeline.py` streams
#: the rest
STREAMED_HERE = {
    "smoke_script", "churn_seed0", "churn_seed1", "churn_seed2",
} | {s.__name__ for s in SCRIPTS
     if s.__name__.startswith(("basic_", "gang_", "quota_", "permit_"))}


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def _streaming(pkg, run, served, module, monkeypatch):
    """`pkg` with `run` streaming in chunks of CHUNK, and its
    `streamed_profile_solve` (looked up in `module`) recording into
    `served` whether it served each solve."""
    real = module.streamed_profile_solve

    def spy(*args, **kw):
        out = real(*args, **kw)
        served.append(out is not None)
        return out

    monkeypatch.setattr(module, "streamed_profile_solve", spy)
    return SimpleNamespace(**{**vars(pkg), "run": run})


def run_streamed(script, monkeypatch):
    """Both packages through `script` with `stream_chunk=CHUNK`; every
    report and the store equal after every cycle, and every solve of
    either package served by its streamed solve. Returns the port's
    reports."""
    served_j, served_p = [], []
    jax = _streaming(
        JAX, lambda s, c, now: JAX.cycle.run_cycle(s, c, now, CHUNK),
        served_j, jax_pipeline, monkeypatch,
    )
    port = _streaming(
        PORT, lambda s, c, now: port_cycle.run_cycle(s, c, now, CHUNK,
                                                     device="cpu"),
        served_p, port_cycle, monkeypatch,
    )
    jc, js, jsteps = script(jax)
    pc, ps, psteps = script(port)
    flush = getattr(script, "requeue_flush_ms", None)
    if flush is not None:
        jc.requeue_flush_ms = flush
        monkeypatch.setattr(port_store, "REQUEUE_FLUSH_MS", flush)
    reports = []
    for k, ((now, jmut), (_, pmut)) in enumerate(zip(jsteps, psteps)):
        if jmut is not None:
            jmut(jax, jc)
            pmut(port, pc)
        jr, pr = jax.run(js, jc, now), port.run(ps, pc, now)
        assert report_diff(jr, pr) == [], (k, jr, pr)
        assert store_diff(jc, pc) == [], (k, store_diff(jc, pc))
        reports.append(pr)
    assert served_p == served_j
    assert served_p and all(served_p), served_p
    return reports


@pytest.mark.parametrize(
    "script", [s for s in SCRIPTS if s.__name__ in STREAMED_HERE],
    ids=lambda s: s.__name__,
)
def test_streamed_cycle_matches_jax(jax_package, script, monkeypatch):
    run_streamed(script, monkeypatch)


def test_streamed_script_reaches_its_outcomes(jax_package, monkeypatch):
    from torch_cycle_scripts import script_outcomes

    assert script_outcomes(run_streamed(smoke_script, monkeypatch)) == []


@pytest.mark.cuda
def test_streamed_cycle_card_matches_cpu(monkeypatch):
    """A churn script and the smoke script through `run_cycle(
    stream_chunk=4)` on the card and on the CPU: every report and the
    store identical after every cycle, every solve streamed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    served = []
    real = port_cycle.streamed_profile_solve

    def spy(*args, **kw):
        out = real(*args, **kw)
        served.append(out is not None)
        return out

    monkeypatch.setattr(port_cycle, "streamed_profile_solve", spy)
    arms = [SimpleNamespace(**{**vars(PORT), "run": lambda s, c, now, d=d:
                               port_cycle.run_cycle(s, c, now, CHUNK,
                                                    device=d)})
            for d in ("cuda", "cpu")]
    for script in (churn_script(0), smoke_script):
        (cc, cs, csteps), (hc, hs, hsteps) = (script(a) for a in arms)
        for (now, cmut), (_, hmut) in zip(csteps, hsteps):
            if cmut is not None:
                cmut(arms[0], cc)
                hmut(arms[1], hc)
            cr, hr = arms[0].run(cs, cc, now), arms[1].run(hs, hc, now)
            assert report_diff(hr, cr) == [], (now, hr, cr)
            assert store_diff(hc, cc) == [], now
    assert served and all(served)
