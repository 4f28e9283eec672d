"""Faults planted under a run's timed path, for the harness's own tests.

Each wraps a program object so that a run goes on as usual but what the
window produces is wrong in one way a broken program could be:
- "half_batch": half of each batch's answers left out (the detector
  returns no boxes for the second half of a window; the pose step returns
  the first half's rows again for the second half; the server answers the
  second half of its requests with another request's result);
- "altered": one answer altered where it is produced (one box moved by
  2 px, one Euler angle moved by 1 degree, one score raised by 1).
The command line never plants one.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future

import numpy as np

KINDS = ("half_batch", "altered")


class Detector:
    def __init__(self, det, kind):
        self.det, self.kind = det, kind

    def __call__(self, frames):
        out = self.det(frames)
        if self.kind == "half_batch":
            h = len(out) // 2
            return out[:h] + [np.zeros((0, 5), np.float32) for _ in out[h:]]
        out = [o.copy() for o in out]
        for o in out:
            if len(o):
                o[0, 0] += 2.0
                break
        return out


class Estimator:
    def __init__(self, est, kind):
        self.est, self.kind = est, kind

    def run_from_frames(self, frames, ids, boxes, chunk=0):
        euler, joints, aa = (np.array(x) for x in self.est.run_from_frames(frames, ids, boxes,
                                                                           chunk=chunk))
        if self.kind == "half_batch":
            h = len(euler) // 2
            n = len(euler) - h
            euler[h:], joints[h:], aa[h:] = euler[:n], joints[:n], aa[:n]
        else:
            euler[len(euler) // 3, 5, 0] += 1.0
        return euler, joints, aa


class Scorer:
    def __init__(self, scorer, kind):
        self.scorer, self.kind = scorer, kind

    def __call__(self, euler, joints, info):
        out = self.scorer(euler, joints, info)
        if self.kind == "altered" and out:
            out = list(out)
            out[len(out) // 2] = dict(out[len(out) // 2], score=out[len(out) // 2]["score"] + 1)
        return out


class Server:
    """Wraps submit(): under "half_batch" every other request gets the
    previous request's result; under "altered" one request's REBA score is
    raised by 1."""

    def __init__(self, server, kind):
        self.server, self.kind = server, kind
        self.n = 0
        self.prev = None

    def __getattr__(self, name):
        return getattr(self.server, name)

    def submit(self, frame, bbox):
        fut = self.server.submit(frame, bbox)
        self.n += 1
        out: Future = Future()
        prev, n = self.prev, self.n

        def relay(f):
            if f.exception() is not None:
                out.set_exception(f.exception())
                return
            r = f.result()
            if self.kind == "half_batch" and n % 2 == 0 and prev is not None:
                r = prev.result()
            elif self.kind == "altered" and n == 10:
                r = dataclasses.replace(r, reba=r.reba + 1)
            out.set_result(r)

        fut.add_done_callback(relay)
        self.prev = fut
        return out
