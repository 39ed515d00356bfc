"""The NEE slice on cornell-box (17,974 triangles, one emissive quad): the
port's ``render_image_wavefront(use_nee=True)`` vs the JAX package's, in both
forms, sort off and on, under the golden rule (see
tests/test_torch_wavefront_nee.py, which holds the helper)."""
import pytest

from test_torch_wavefront_nee import check_nee_render


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("fused_nee", [False, True])
def test_cornell_nee_render_matches_jax(fused_nee, sort):
    check_nee_render("cornell-box", fused_nee, sort)
