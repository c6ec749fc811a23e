"""The port's planlint against the reference's: the same single-stage
programs give the same diagnostics (rule id, level, message, location)
for every rule a port plan can reach (PL001, PL002, PL005), and the
explain report lists the same findings."""

import dataclasses
import warnings

import pytest

from repro.analysis import planlint as jplanlint
from repro.engine import stages as jstages
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import Windowing as JWindowing

from repro_torch.analysis import PlanLintWarning, planlint
from repro_torch.engine import stages
from repro_torch.pipeline import Pipeline, Windowing


def _build(P, Wn, *, window=("tumbling", 10.0), sink="out/", prefix=None,
           **kw):
    w = (Wn.session(window[1]) if window[0] == "session"
         else getattr(Wn, window[0])(*window[1:]))
    kw.setdefault("num_buckets", 8)
    kw.setdefault("n_workers", 4)
    src = (P.from_source(prefix=prefix, batch_records=64) if prefix
           else P.from_source(batch_records=64))
    extra = {"backend": "pallas"} if P is JPipeline else {"device": "cpu"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (src.key_by().window(w).reduce("sum").sink(sink)
                .build(job_id="plt", **kw, **extra))


def _shrink_ring(built, n_slots):
    st = dataclasses.replace(built.stages[0], n_slots=n_slots)
    return dataclasses.replace(built, stages=(st,))


def _findings(diags):
    return [(d.rule_id, d.level, d.message, d.loc) for d in diags]


CASES = {
    "clean": dict(),
    "pl001_ring_too_small": dict(n_slots=1),
    "pl001_sliding_ring": dict(window=("sliding", 60.0, 20.0), n_slots=5,
                               shrink=3, allowed_lateness=10.0),
    "pl001_session_single_slot": dict(window=("session", 5.0), shrink=1),
    "pl002_hashed_warning": dict(key_space="hashed", num_buckets=1 << 14),
    "pl002_hashed_info": dict(key_space="hashed", num_buckets=16),
    "pl005_reserved_namespace": dict(sink="jobs/out/"),
    "pl005_sink_under_source_log": dict(prefix="logs/in",
                                        sink="logs/in/rollup/"),
    "pl005_run_time_source_binding": dict(sink="rollup/", bind=("rollup/",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_planlint_matches_reference(case):
    kw = dict(CASES[case])
    shrink = kw.pop("shrink", None)
    bind = kw.pop("bind", ())
    if "n_slots" in kw and shrink is None:
        shrink = kw.pop("n_slots")
    built = {}
    for P, Wn in ((JPipeline, JWindowing), (Pipeline, Windowing)):
        b = _build(P, Wn, **kw)
        built[P] = _shrink_ring(b, shrink) if shrink is not None else b
    ref = _findings(built[JPipeline].check(source_prefixes=bind))
    assert _findings(built[Pipeline].check(source_prefixes=bind)) == ref
    assert (ref == []) == (case == "clean")
    assert all(rule in case.upper() for rule, *_ in ref)
    report = built[Pipeline].explain(source_prefixes=bind)
    assert ("planlint: clean" in report) == (case == "clean")
    for rule, *_ in ref:
        assert rule in report


def test_planlint_constants_match_engine_and_reference():
    assert planlint.RAW_KEY_BITS == stages.RAW_KEY_BITS \
        == jstages.RAW_KEY_BITS == jplanlint.RAW_KEY_BITS
    assert planlint.COLLISION_WARN_P == jplanlint.COLLISION_WARN_P
    assert planlint.RESERVED_PREFIXES == jplanlint.RESERVED_PREFIXES
    assert set(planlint.RULES) == {"PL001", "PL002", "PL005"}
    for rule, text in planlint.RULES.items():
        assert jplanlint.RULES[rule] == text
    for args in [(10.0,), (10.0, None, 5.0), (60.0, 20.0), (300.0, 60.0, 5.0)]:
        assert planlint.min_slots_required(*args) \
            == jplanlint.min_slots_required(*args)


def test_build_warns_planlint_findings():
    src = Pipeline.from_source(batch_records=64).key_by() \
        .window(Windowing.tumbling(10.0)).reduce("sum").sink("out/")
    with pytest.warns(PlanLintWarning, match="PL002"):
        src.build(key_space="hashed", num_buckets=1 << 14, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        src.build(num_buckets=8, device="cpu")
