"""State carried across packages as plain numpy arrays and floats.

The system has no weights; what an alignment step consumes is a pair of
graphs, a substitution model and the DP score parameters.  ``to_arrays``
flattens any object with that shape (duck-typed: the port's classes or
another implementation's) and ``from_reference_arrays`` builds the port's
``Graph``, ``Model`` and ``DynProgScores`` from the flat form, so two
implementations can be handed the same pair without importing each other's
classes.
"""

from __future__ import annotations

import numpy as np

from .align.scores import DynProgScores
from .graph.graph import Graph
from .models.factory import Model

SCORE_FIELDS = ("gap_extend", "gap_init", "start_gap", "start_init",
                "end_match", "end_gap", "end_skip", "match_init",
                "repeat_init", "repeat_ext")
MODEL_SCALARS = ("delta", "epsilon", "distance", "divergence")


def graph_to_arrays(g) -> dict:
    """sites [n, dim] f64 and one edge list: e_to, e_from int32, e_cost f32,
    e_rep bool (a repeat edge carries its unit count in e_units, cost 0)."""
    rows = [(i, p, c, False, 0) for i in range(g.size) for p, c in g.preds[i]]
    rows += [(i, p, 0.0, True, u) for i in range(g.size) for p, u in g.reps[i]]
    cols = list(zip(*rows)) if rows else [()] * 5
    return {"sites": np.array(g.sites, dtype=np.float64),
            "e_to": np.array(cols[0], dtype=np.int32),
            "e_from": np.array(cols[1], dtype=np.int32),
            "e_cost": np.array(cols[2], dtype=np.float32),
            "e_rep": np.array(cols[3], dtype=bool),
            "e_units": np.array(cols[4], dtype=np.int32)}


def to_arrays(g1, g2, model, scores) -> dict:
    """The flat form of one alignment step's inputs."""
    return {"g1": graph_to_arrays(g1), "g2": graph_to_arrays(g2),
            "M": np.array(model.M), "pi": np.array(model.pi),
            "P": np.array(model.P), "Q": np.array(model.Q),
            "model": {k: float(getattr(model, k)) for k in MODEL_SCALARS},
            "scores": {k: np.float32(getattr(scores, k))
                       for k in SCORE_FIELDS}}


def graph_from_arrays(a: dict) -> Graph:
    n = a["sites"].shape[0]
    preds = [[] for _ in range(n)]
    reps = [[] for _ in range(n)]
    for to, frm, cost, rep, units in zip(a["e_to"].tolist(),
                                         a["e_from"].tolist(), a["e_cost"],
                                         a["e_rep"].tolist(),
                                         a["e_units"].tolist()):
        if rep:
            reps[to].append((frm, units))
        else:
            preds[to].append((frm, np.float32(cost)))
    for lst in preds + reps:
        lst.sort(key=lambda t: t[0])
    return Graph(np.array(a["sites"], dtype=np.float64), preds, reps)


def from_reference_arrays(a: dict):
    """(g1, g2, model, scores) of the port from ``to_arrays``' flat form."""
    model = Model(M=np.array(a["M"]), P=np.array(a["P"]), Q=np.array(a["Q"]),
                  pi=np.array(a["pi"]), **a["model"])
    scores = DynProgScores.__new__(DynProgScores)
    for k in SCORE_FIELDS:
        setattr(scores, k, np.float32(a["scores"][k]))
    return (graph_from_arrays(a["g1"]), graph_from_arrays(a["g2"]), model,
            scores)
