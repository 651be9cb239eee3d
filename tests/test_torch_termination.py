"""The port's Mattern termination detector (`repro_torch.core.termination`)
on a simulated asynchronous transport: the cases of tests/test_termination.py,
and the JAX package's detector held beside it on the same seeded traffic."""

import random

import pytest

pytest.importorskip("torch")

import repro.core.termination as jterm  # noqa: E402
import repro_torch.core.termination as tterm  # noqa: E402


class SimTransport:
    """Async message simulator with arbitrary (seeded) delivery order."""

    def __init__(self, n, seed=0, term=tterm):
        self.tree = term.TernaryTree(n)
        self.det = [term.TerminationDetector(i, self.tree) for i in range(n)]
        self.control: list[tuple[int, object]] = []
        self.basic: list[tuple[int, int]] = []  # (dst, stamp)
        self.rng = random.Random(seed)

    def send_basic(self, src, dst):
        stamp = self.det[src].on_basic_send()
        self.basic.append((dst, stamp))

    def deliver_one_basic(self):
        if not self.basic:
            return False
        i = self.rng.randrange(len(self.basic))
        dst, stamp = self.basic.pop(i)
        self.det[dst].on_basic_receive(stamp)
        return True

    def run_wave(self):
        msgs = list(self.det[0].start_wave())
        while msgs:
            i = self.rng.randrange(len(msgs))
            dst, payload = msgs.pop(i)
            msgs.extend(self.det[dst].handle_control(payload))
        return self.det[0].terminated


def test_port_exports_the_jax_names():
    assert tterm.__all__ == jterm.__all__


@pytest.mark.parametrize("n", [1, 2, 3, 7, 13])
def test_ternary_tree_matches_jax(n):
    jt, tt = jterm.TernaryTree(n), tterm.TernaryTree(n)
    for i in range(n):
        assert tt.parent(i) == jt.parent(i)
        assert tt.children(i) == jt.children(i)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 13])
def test_quiet_system_terminates(n):
    sim = SimTransport(n)
    assert sim.run_wave()


def test_in_flight_message_defers_termination():
    """The classic race: counters sum to zero only after delivery."""
    sim = SimTransport(5)
    sim.send_basic(1, 3)  # one basic message in flight
    assert not sim.run_wave()  # counter sum = +1 -> not terminated
    sim.deliver_one_basic()
    # first wave after delivery sees a stale stamp (crossed the boundary)
    assert not sim.run_wave()
    # quiet since -> next wave terminates
    assert sim.run_wave()


def test_crossing_send_receive_pair_is_caught():
    """Equal send/recv counts must not fake termination (time-stamp check)."""
    sim = SimTransport(4, seed=3)
    # message sent in epoch 0, still in flight
    sim.send_basic(2, 1)
    sim.run_wave()  # epoch 1 begins; counter nonzero -> no termination
    # deliver the old message (stamp 0 < clock 1) and send+deliver a fresh pair
    sim.deliver_one_basic()
    sim.send_basic(1, 2)
    sim.deliver_one_basic()
    # counters all zero now, but the stale receive must veto this wave
    assert not sim.run_wave()
    assert sim.run_wave()


def test_busy_process_blocks_termination():
    sim = SimTransport(3)
    sim.det[2].is_idle = lambda: False
    assert not sim.run_wave()
    sim.det[2].is_idle = lambda: True
    assert sim.run_wave()


def test_unknown_control_message_raises():
    det = tterm.TerminationDetector(0, tterm.TernaryTree(1))
    with pytest.raises(ValueError):
        det.handle_control(("gossip", None))


def _random_traffic(seed, term):
    """The random-traffic scenario; returns (waves' outcomes, final state).

    Termination latches (it is permanent in a real system), so the traffic
    generator stops once a wave first declares it."""
    rng = random.Random(seed)
    sim = SimTransport(9, seed=seed, term=term)
    waves = []
    for _ in range(200):
        action = rng.random()
        if action < 0.4:
            sim.send_basic(rng.randrange(9), rng.randrange(9))
        elif action < 0.8:
            sim.deliver_one_basic()
        else:
            waves.append(sim.run_wave())
            if waves[-1]:
                assert not sim.basic, "false termination with in-flight messages"
                return waves, sim
    # drain and require termination within two clean waves
    while sim.deliver_one_basic():
        pass
    waves.append(sim.run_wave())
    waves.append(sim.run_wave())
    assert waves[-1]
    return waves, sim


@pytest.mark.parametrize("seed", range(5))
def test_random_traffic_never_false_terminates(seed):
    """Property: termination is declared only when no message is in flight."""
    _random_traffic(seed, tterm)


@pytest.mark.parametrize("seed", range(5))
def test_random_traffic_matches_jax(seed):
    """The same seeded traffic through both packages' detectors: the same
    wave outcomes, clocks and counters."""
    waves, sim = _random_traffic(seed, tterm)
    jwaves, jsim = _random_traffic(seed, jterm)
    assert waves == jwaves
    assert [(d.clock, d.counter, d.terminated) for d in sim.det] == \
        [(d.clock, d.counter, d.terminated) for d in jsim.det]
