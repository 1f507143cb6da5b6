"""What the frozen copy keeps of walk_these_ways_tpu_torch/ops/_build.py: the
robot's topology tables, which the plain versions read.  The reference builds
and launches no kernel."""
from __future__ import annotations

import numpy as np


def topology(anc, cp_body):
    """(anc (nv, nb) bool, anc_p (P, nv) bool, point->dof groups) from the
    ancestor mask and the contact points' bodies."""
    from .contact import point_dof_groups
    anc = np.asarray(anc).astype(bool)                         # (nv, nb)
    anc_p = anc[:, np.asarray(cp_body)].T                      # (P, nv)
    return anc, anc_p, tuple(point_dof_groups(anc_p))
