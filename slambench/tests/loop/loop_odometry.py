"""A loop-closure configuration's check (``checks/<name>.py``), as the
CPU tests and the card's probe (`slambench.tests.loop_probe`) use it.

The plain reference computes no loop closure, and the frame path's
odometry does not depend on it: `slambench.check.judge` judges the
odometry with ``loop_closure`` taken out of the reference's
configuration.  The frame path's own state under loop closure and the
loop service's work are judged from what this module keeps:

* ``touched_unadmitted``: the kept window frames that touched a cell
  of the full-cloud map (``last_touched``, kept by `to_reference_state`)
  though the history did not admit them (its pointer unmoved): the frame
  path inserts only an admitted frame's points;
* ``keyframes_short``: 1 where the service had processed no keyframe
  after the pipeline's flush (`keep`), else 0.
"""
import copy
import dataclasses

from slambench import check


def to_reference_state(state):
    """The reference's state and the count of cells the frame touched."""
    if state is None:
        return None
    return check.to_reference_state(state), int(state.last_touched.sum())


def keep(pipe):
    """The keyframes the loop service had processed after the flush."""
    return {"keyframes": len(pipe.loop_closer.keyframes)}


def _reference(snap):
    unwrap = (lambda s: None if s is None else s[0])
    return dataclasses.replace(snap, pre=unwrap(snap.pre), post=unwrap(snap.post))


def judge(cfg_doc, frames, dev, rows, per_frame, start, snaps, n_frames_run, kept,
          control=None):
    doc = copy.deepcopy(cfg_doc)
    del doc["slam"]["loop_closure"]
    checks, window_gaps = check.judge(doc, frames, dev, rows, per_frame, _reference(start),
                                      [_reference(s) for s in snaps], n_frames_run,
                                      control=control)
    checks["touched_unadmitted"] = float(sum(
        1 for s in snaps if s.post[1] > 0 and int(s.pre[0].hist_ptr) == int(s.post[0].hist_ptr)))
    checks["keyframes_short"] = float(kept["keyframes"] < 1)
    return checks, window_gaps
