"""The rank of a ``predict`` input, for every classifier kind of the port.

A compiled artifact takes a 2-D (N, F) batch of rows.  A single 1-D row
raises ``ValueError`` (it is ``x[None]``), on the kernel route and on the
``ref`` backend alike, where it used to return a label for some kinds and
raise ``IndexError`` for others; a 3-D input raises too.  A one-row batch
still predicts as the same row inside a larger batch.
"""

import numpy as np
import pytest

from repro_torch import compile as tc
from repro_torch.convert import model_from_params
from repro_torch.models import train_decision_tree

from _torch_port_cases import fleet_blobs, fleet_params

KINDS = ("mlp", "logistic", "svm-linear", "svm-poly", "svm-rbf", "tree")


@pytest.fixture(scope="module")
def blobs():
    return fleet_blobs()


def _model(kind, x, y):
    if kind == "tree":
        return train_decision_tree(x, y, int(y.max()) + 1, max_depth=4)
    if kind == "svm-linear":
        _, p = fleet_params("logistic", 3, x, y)
        return model_from_params(kind, p)
    return model_from_params(*fleet_params(kind, 3, x, y))


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("kind", KINDS)
def test_predict_refuses_a_row_that_is_not_a_batch(blobs, kind, backend):
    x, y, x_test, _ = blobs
    art = tc.compile(_model(kind, x, y),
                     tc.Target(backend=backend, number_format="fxp16"),
                     device="cpu")
    batch = art.predict(x_test[:5])
    assert batch.shape == (5,)
    assert art.predict(x_test[2:3]).tolist() == [batch[2]]
    with pytest.raises(ValueError, match="2-D"):
        art.predict(x_test[2])
    with pytest.raises(ValueError, match="2-D"):
        art.predict(x_test[None, :5])
