"""The traffic generator: each block holds the mix exactly, in an order
drawn from the seed, and the same seed gives the same lengths."""
import collections
import itertools

import pytest

from harness import manifest, traffic

MIXES = ("prefill-long", "prefill-chat", "prefill-short")


def _mix(name):
    import json
    return json.loads((manifest.BENCH / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_every_block_holds_the_mix_exactly(name, seed):
    t = _mix(name)
    n = sum(t["steps"])
    want = dict(zip(t["lengths"], t["steps"]))
    got = traffic.first_steps(t, seed, 20 * n)
    for b in range(20):
        assert collections.Counter(got[b * n:(b + 1) * n]) == want


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_lengths_other_seed_other_order(name):
    t = _mix(name)
    a = traffic.first_steps(t, 2**33 + 5, 200)
    assert a == traffic.first_steps(t, 2**33 + 5, 200)
    assert a != traffic.first_steps(t, 2**33 + 6, 200)


@pytest.mark.parametrize("name", MIXES)
def test_each_step_holds_the_step_budget(name):
    t = _mix(name)
    for L in t["lengths"]:
        assert traffic.batch_rows(t, L) * L == t["tokens_per_step"]


def test_a_length_that_does_not_divide_the_budget_is_refused():
    with pytest.raises(ValueError):
        traffic.batch_rows({"tokens_per_step": 1000}, 3)


def test_streams_are_independent():
    a = traffic.rng(5, "lengths").integers(1 << 30, size=4)
    b = traffic.rng(5, "sample").integers(1 << 30, size=4)
    assert list(a) != list(b)
    assert list(itertools.islice(traffic.lengths(_mix("prefill-long"), 5),
                                 10)) == traffic.first_steps(
        _mix("prefill-long"), 5, 10)
