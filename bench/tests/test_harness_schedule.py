"""The open-loop schedule: drawn from the seed, timed from due times."""
import numpy as np

from harness.schedule import (due_latencies, lateness, poisson_offsets,
                              send_on_schedule)


def test_poisson_offsets_from_the_seed():
    a = poisson_offsets(1000.0, 20000, seed=3)
    assert np.array_equal(a, poisson_offsets(1000.0, 20000, seed=3))
    assert not np.array_equal(a, poisson_offsets(1000.0, 20000, seed=4))
    assert np.all(np.diff(a) >= 0)
    assert abs(a[-1] / len(a) - 1e-3) < 5e-5


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_a_stall_counts_against_the_requests_behind_it():
    clock = FakeClock()
    offsets = np.array([0.0, 1.0, 2.0, 3.0])
    done = []

    def submit(i):
        if i == 1:
            clock.t += 2.5          # the submitter stalls on request 1
        done.append(clock.t + 0.1)  # each answer 0.1 s after it went

    t0, sent, _ = send_on_schedule(submit, range(4), offsets, clock,
                                   clock.sleep)
    late = lateness(t0, offsets, sent)
    lat = due_latencies(t0, offsets, done)
    assert np.allclose(late, [0.0, 0.0, 1.5, 0.5])
    # from the due time, request 2 waited behind the stall: 1.6 s, not
    # the 0.1 s a latency from its send would show
    assert np.allclose(lat, [0.1, 2.6, 1.6, 0.6])
