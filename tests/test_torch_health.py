"""The port's run health and degradation ladder
(``repro_torch.launch.health``): twins of tests/test_rollback.py's
RunHealth and ladder tests, with ``apply_rung`` on the port's
``RobustConfig``, and one check that both packages parse a ladder and
refuse a rung alike."""
import dataclasses

import pytest

from repro.launch import health as jhealth
from repro_torch.core.robust_step import RobustConfig
from repro_torch.launch.health import (RunHealth, _LADDER_FORBIDDEN,
                                       apply_rung, parse_ladder)


def test_runhealth_patience_on_rejected_rounds():
    h = RunHealth(patience=3)
    for _ in range(2):
        h.observe({"round_accepted": 0.0, "loss": 1.0})
    assert not h.rollback_pending
    h.observe({"round_accepted": 1.0, "loss": 1.0})   # a good round resets
    assert h.healthy
    for _ in range(3):
        h.observe({"round_accepted": 0.0, "loss": 1.0})
    assert h.rollback_pending and not h.healthy


def test_runhealth_nonfinite_and_blowup_losses_are_bad():
    h = RunHealth(patience=2, blowup=10.0)
    h.observe({"loss": 1.0})
    h.observe({"loss": float("nan")})
    h.observe({"loss": float("inf")})
    assert h.rollback_pending
    h2 = RunHealth(patience=2, blowup=10.0)
    h2.observe({"loss": 1.0})
    h2.observe({"loss": 5.0})          # within blowup x best
    assert h2.healthy
    h2.observe({"loss": 11.0})         # > 10 x best (1.0)
    h2.observe({"loss": 12.0})
    assert h2.rollback_pending


def test_runhealth_rollback_and_dismiss_bookkeeping():
    h = RunHealth(patience=1)
    h.observe({"round_accepted": 0.0})
    assert h.rollback_pending
    h.on_rollback()
    assert h.rollbacks == 1 and not h.rollback_pending and h.healthy
    h.observe({"round_accepted": 0.0})
    assert h.rollback_pending
    h.dismiss()                        # no checkpoint available
    assert h.rollbacks == 1 and not h.rollback_pending
    assert h.summary() == {"rollbacks": 1, "ladder_rungs_used": 0}
    with pytest.raises(ValueError):
        RunHealth(patience=0)


def test_parse_ladder_groups_and_errors():
    rungs = parse_ladder("trim=2; aggregator=trimmed_mean , trim=3 ;")
    assert rungs == [{"trim": "2"},
                     {"aggregator": "trimmed_mean", "trim": "3"}]
    assert parse_ladder("") == []
    with pytest.raises(ValueError, match="key=value"):
        parse_ladder("trim")


def test_apply_rung_coerces_to_field_types():
    base = RobustConfig()
    out = apply_rung(base, {"trim": "2", "guard_multiplier": "4.5",
                            "diagnostics": "true", "aggregator": "krum"})
    assert out.trim == 2 and isinstance(out.trim, int)
    assert out.guard_multiplier == 4.5
    assert out.diagnostics is True
    assert out.aggregator == "krum"
    assert base.trim == 1              # the frozen original is untouched


def test_apply_rung_refuses_unknown_and_structural_fields():
    base = RobustConfig()
    with pytest.raises(ValueError, match="no field"):
        apply_rung(base, {"not_a_field": "1"})
    for field in ("vr", "message_dtype", "num_clients", "guards", "comm",
                  "packed", "topology"):
        with pytest.raises(ValueError, match="structure"):
            apply_rung(base, {field: "x"})


def test_escalate_walks_rungs_then_exhausts():
    h = RunHealth(patience=1, ladder="trim=2;trim=3,aggregator=geomed")
    base = RobustConfig(aggregator="trimmed_mean")
    assert h.escalate(base) is base    # no rollback yet
    h.on_rollback()
    r1 = h.escalate(base)
    assert r1.trim == 2 and r1.aggregator == "trimmed_mean"
    h.on_rollback()
    r2 = h.escalate(base)
    assert r2.trim == 3 and r2.aggregator == "geomed"
    h.on_rollback()
    assert h.escalate(base) is base    # the ladder is spent
    assert h.summary() == {"rollbacks": 3, "ladder_rungs_used": 2}


def test_ladder_matches_reference():
    from repro.core.robust_step import RobustConfig as JConfig
    spec = "trim=3;aggregator=trimmed_mean,trim=4,guard_multiplier=2.5"
    assert parse_ladder(spec) == jhealth.parse_ladder(spec)
    assert _LADDER_FORBIDDEN == jhealth._LADDER_FORBIDDEN
    for rung in parse_ladder(spec):
        assert (dataclasses.asdict(apply_rung(RobustConfig(), rung))
                == dataclasses.asdict(jhealth.apply_rung(JConfig(), rung)))
