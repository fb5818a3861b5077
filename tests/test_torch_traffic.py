"""The port's traffic generator against the reference's.

`repro_torch.traffic.generator` is numpy only, so for the same pattern
both packages must give the same trace, request for request and field for
field (rid, t, label, prompt_len, new_tokens: exact), and the same
`label_mix`. Four seeded patterns cover what the generator composes: a
diurnal cycle, a flash crowd on one label, a long-prompt flood, and a
Zipf-tailed multi-tenant mix; one more composes all of them. The port's own
properties (determinism, well-formed arrivals, the mix converging to the
weights, fail-closed validation) mirror `tests/test_properties.py`'s."""
import dataclasses

import pytest

import repro.traffic.generator as jgen
import repro_torch.traffic.generator as tgen


def _pattern(g, case):
    """The pattern ``case`` built from generator module ``g``."""
    two = {"phi": g.LabelProfile(weight=1.0), "general": g.LabelProfile(weight=2.0)}
    if case == "diurnal":
        return g.TrafficPattern(duration_s=120.0, base_rate=20.0, labels=two,
                                diurnal_amplitude=0.8, diurnal_period_s=60.0, seed=1)
    if case == "flash_crowd_phi":
        return g.TrafficPattern(
            duration_s=40.0, base_rate=10.0, labels=two, seed=2,
            flash_crowds=(g.FlashCrowd(t_start=10.0, duration_s=8.0, multiplier=5.0,
                                       label="phi"),))
    if case == "long_prompt_flood":
        return g.TrafficPattern(
            duration_s=40.0, base_rate=8.0, labels=two, seed=3,
            floods=(g.LongPromptFlood(t_start=5.0, duration_s=10.0, rate=12.0,
                                      label="general", prompt_len=24, new_tokens=2),))
    if case == "zipf_mix":
        labels = {f"t{i}": g.LabelProfile(weight=1.0 / (i + 1),
                                          prompt_buckets=(4, 8, 16, 64, 256, 1024),
                                          prompt_tail=1.6, new_tokens_mean=6.0,
                                          new_tokens_cap=64)
                  for i in range(5)}
        return g.TrafficPattern(duration_s=60.0, base_rate=30.0, labels=labels,
                                diurnal_amplitude=0.0, seed=4, bin_s=0.5)
    if case == "all_of_them":
        return g.TrafficPattern(
            duration_s=24.0, base_rate=2.0, labels={
                "phi": g.LabelProfile(prompt_buckets=(17, 64, 100, 150, 200, 256, 320, 384),
                                      new_tokens_mean=12.0, new_tokens_cap=16),
                "general": g.LabelProfile(prompt_buckets=(17, 64, 100, 150, 200, 256, 320,
                                                          384),
                                          new_tokens_mean=12.0, new_tokens_cap=16)},
            flash_crowds=(g.FlashCrowd(t_start=6.0, duration_s=8.0, multiplier=4.0,
                                       label="phi"),),
            floods=(g.LongPromptFlood(t_start=2.0, duration_s=3.0, rate=1.0,
                                      label="general", prompt_len=384),),
            seed=0)
    raise KeyError(case)


CASES = ["diurnal", "flash_crowd_phi", "long_prompt_flood", "zipf_mix", "all_of_them"]


def _fields(trace):
    return [(r.rid, r.t, r.label, r.prompt_len, r.new_tokens) for r in trace]


@pytest.mark.parametrize("case", CASES)
def test_trace_equals_reference(case):
    want = jgen.generate_trace(_pattern(jgen, case))
    got = tgen.generate_trace(_pattern(tgen, case))
    assert len(want) > 20
    assert _fields(got) == _fields(want)
    assert tgen.label_mix(got) == jgen.label_mix(want)
    pj, pt = _pattern(jgen, case), _pattern(tgen, case)
    for t in (0.0, 7.5, 11.0, 33.3):
        for label in sorted(pj.labels):
            assert pt.rate_at(t, label) == pj.rate_at(t, label)


def test_pattern_events_shape_the_trace():
    """Each event leaves its mark: the crowd multiplies phi's arrivals in
    its window, the flood adds its fixed-shape prompts, the Zipf tail puts
    most prompts in the shortest buckets."""
    crowd = tgen.generate_trace(_pattern(tgen, "flash_crowd_phi"))
    inside = sum(r.label == "phi" and 10.0 <= r.t < 18.0 for r in crowd)
    before = sum(r.label == "phi" and 0.0 <= r.t < 8.0 for r in crowd)
    assert inside > 2 * before
    flood = tgen.generate_trace(_pattern(tgen, "long_prompt_flood"))
    assert sum((r.prompt_len, r.new_tokens) == (24, 2) and 5.0 <= r.t < 15.0
               for r in flood) > 60
    zipf = tgen.generate_trace(_pattern(tgen, "zipf_mix"))
    short = sum(r.prompt_len <= 8 for r in zipf)
    assert short > len(zipf) / 2 > sum(r.prompt_len >= 256 for r in zipf)


@pytest.mark.parametrize("case", CASES)
def test_trace_seeded_monotone_and_well_formed(case):
    """A pattern is a pure function of its seed; arrivals are monotone in
    [0, duration), rids dense, shapes within the label's profile."""
    pattern = _pattern(tgen, case)
    trace = tgen.generate_trace(pattern)
    assert tgen.generate_trace(pattern) == trace
    assert tgen.generate_trace(dataclasses.replace(pattern, seed=pattern.seed ^ 1)) != trace
    flood_shapes = {(f.label, f.prompt_len, f.new_tokens) for f in pattern.floods}
    prev = 0.0
    for i, r in enumerate(trace):
        assert r.rid == i and prev <= r.t < pattern.duration_s
        prev = r.t
        prof = pattern.labels[r.label]
        if (r.label, r.prompt_len, r.new_tokens) not in flood_shapes:
            assert r.prompt_len in prof.prompt_buckets
            assert 1 <= r.new_tokens <= prof.new_tokens_cap


def test_label_mix_converges_to_weights():
    pattern = tgen.TrafficPattern(
        duration_s=60.0, base_rate=60.0, seed=7,
        labels={"a": tgen.LabelProfile(weight=1.0), "b": tgen.LabelProfile(weight=3.0)})
    trace = tgen.generate_trace(pattern)
    assert len(trace) > 1000
    mix = tgen.label_mix(trace)
    assert abs(mix["a"] - 0.25) < 0.05 and abs(mix["b"] - 0.75) < 0.05
    assert tgen.label_mix([]) == {}


@pytest.mark.parametrize("bad", [
    lambda g: g.LabelProfile(weight=-1.0),
    lambda g: g.LabelProfile(prompt_buckets=()),
    lambda g: g.LabelProfile(new_tokens_mean=0.5),
    lambda g: g.TrafficPattern(duration_s=0.0, base_rate=1.0, labels={"a": g.LabelProfile()}),
    lambda g: g.TrafficPattern(duration_s=1.0, base_rate=1.0, labels={}),
    lambda g: g.TrafficPattern(duration_s=1.0, base_rate=1.0, labels={"a": g.LabelProfile()},
                               diurnal_amplitude=1.0),
    lambda g: g.TrafficPattern(duration_s=1.0, base_rate=1.0, labels={"a": g.LabelProfile()},
                               bin_s=0.0),
    lambda g: g.generate_trace(g.TrafficPattern(duration_s=1.0, base_rate=1.0,
                                                labels={"a": g.LabelProfile(weight=0.0)})),
], ids=["weight", "buckets", "mean", "duration", "labels", "amplitude", "bin", "zero_mix"])
def test_invalid_patterns_raise_as_the_reference(bad):
    for g in (jgen, tgen):
        with pytest.raises(ValueError):
            bad(g)
