"""The port's eigCG on the (t, y) mesh of gloo ranks under the overlap
policy: the worker's three columns in sequence held by the tests of
tests/_torch_eigcg_mesh.py (which describes them), one torchrun launch
in this file.
Cost: about 50 s serial."""
import pytest

from _torch_eigcg_mesh import (ranks_of, test_sharded_eigcg_matches_one_card,  # noqa: F401
                               test_sharded_eigcg_matches_tpuqcd)


@pytest.fixture(scope="module", params=["ty"], ids=lambda m: f"{m}-overlap")
def ranks(request, tmp_path_factory):
    return ranks_of(request.param, tmp_path_factory)
