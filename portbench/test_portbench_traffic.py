"""The traffic generator repeats from a seed, and every seed sends the
same work in another order."""
import numpy as np
import pytest

from portbench import programs, spec, traffic

BIG = 2 ** 31 + 977


def test_open_loop_repeats_and_keeps_its_size():
    a = traffic.open_loop_schedule(BIG, 30.0, 10.0, 13)
    b = traffic.open_loop_schedule(BIG, 30.0, 10.0, 13)
    c = traffic.open_loop_schedule(BIG + 1, 30.0, 10.0, 13)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for due, progs in (a, c):
        assert len(due) == 300 and 0 <= due[0] and due[-1] < 10.0
        assert np.all(np.diff(due) >= 0)
        assert sorted(np.bincount(progs, minlength=13))[0] >= 300 // 13
    # the same counts of each program and the same span, in another order
    assert np.array_equal(np.bincount(a[1]), np.bincount(c[1]))
    assert abs(a[0][-1] - c[0][-1]) < 0.05


SWEEP = {"lanes_per_drain": 4, "drains_per_program": 6,
         "whole_max_steps": 200}


def test_sampling_repeats():
    lanes = [traffic.drain_lanes(SWEEP, BIG, d, p, 1024)
             for d in range(4) for p in range(13)]
    assert lanes == [traffic.drain_lanes(SWEEP, BIG, d, p, 1024)
                     for d in range(4) for p in range(13)]
    # the batch's first and last lanes and two more, drawn
    assert all(len(x) == 4 and x[0] == 0 and x[-1] == 1023 for x in lanes)
    assert len({tuple(x) for x in lanes}) > 1
    keys = list(range(10))
    got = traffic.pick(BIG, keys, 4, must=[9])
    assert got == traffic.pick(BIG, keys, 4, must=[9])
    assert 9 in got and len(set(got)) == 4


@pytest.mark.parametrize("steps", [94, 28969])
def test_sweep_sample_holds_the_last_drain(steps):
    got = traffic.sweep_sample(SWEEP, BIG, 3, steps, 1024, 11)
    assert got == traffic.sweep_sample(SWEEP, BIG, 3, steps, 1024, 11)
    assert len(got) == 6 and 10 in got
    # a cheap program's last drain is held whole, another's sampled
    assert len(got[10]) == (1024 if steps <= 200 else 4)
    assert all(len(v) == 4 for d, v in got.items() if d != 10)


def test_service_sample_holds_every_cheap_request():
    mix = {"sample_per_program": 5, "whole_max_steps": 200}
    _, prog_of = traffic.open_loop_schedule(BIG, 30.0, 10.0, 3)
    keep = traffic.service_sample(mix, BIG, prog_of, [94, 475, 28969])
    assert keep == traffic.service_sample(mix, BIG, prog_of,
                                          [94, 475, 28969])
    by = [sorted(i for i in keep if prog_of[i] == p) for p in range(3)]
    assert by[0] == np.nonzero(prog_of == 0)[0].tolist()
    for p in (1, 2):
        assert len(by[p]) == 5
        assert np.nonzero(prog_of == p)[0][-1] in by[p]


@pytest.mark.parametrize("name", ["egpu-dp", "egpu-dot"])
def test_inputs_repeat_from_the_seed(name):
    doc = spec.cell(spec.load(), f"{name}.sweep").config
    _, progs = programs.load(doc, [doc["programs"][0]["name"]])
    p = progs[0]
    x = programs.Inputs("cpu", BIG, traffic.WINDOW).draw(p, 3)
    y = programs.Inputs("cpu", BIG, traffic.WINDOW).draw(p, 3)
    z = programs.Inputs("cpu", BIG, traffic.WARMUP).draw(p, 3)
    assert x.shape == (3, p.init_words) and np.array_equal(x, y)
    assert not np.array_equal(x, z)
    assert np.array_equal(x[:, p.input_words:],
                          np.broadcast_to(p.fixed, (3, p.fixed.size)))
