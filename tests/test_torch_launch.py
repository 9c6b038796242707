"""The rank launcher's failure paths (CPU, gloo): a rank's exception and
the call's deadline both make ``launch.spawn`` raise in the parent, and no
rank outlives the call.  Its results and collectives are covered by
``tests/test_torch_parallel.py``."""
import multiprocessing

import numpy as np
import pytest
import torch

from srsran_project_23_5_tpu_torch import entry as tentry
from srsran_project_23_5_tpu_torch.parallel import launch

torch.set_num_threads(1)


def test_rank_exception_raises_in_the_parent():
    """Each rank refuses a halo longer than its 8 samples; the parent
    raises with the rank's traceback."""
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*"
                       r"halo 9 outside 1\.\.8 samples"):
        launch.spawn(2, tentry.mesh_report, np.zeros((2, 8), np.float32), 9,
                     backend="gloo", device="cpu")
    assert not multiprocessing.active_children()


def test_deadline_kills_the_ranks():
    """A deadline shorter than a rank's start-up: TimeoutError, and the
    rank is killed."""
    with pytest.raises(TimeoutError, match=r"ranks \[0\] gave no result"):
        launch.spawn(1, tentry.mesh_report, np.zeros((1, 8), np.float32), 2,
                     backend="gloo", device="cpu", timeout_s=0.2)
    assert not multiprocessing.active_children()
