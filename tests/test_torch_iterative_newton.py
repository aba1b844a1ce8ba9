"""``solver.iterative`` on Newton rolling-shutter rows against the JAX
package's ``make_iterative_step``: ``tests/test_torch_iterative_rows.py``'s
check on its Newton problem, in a file of its own (the JAX step's compile
takes most of half a minute)."""
from test_torch_iterative_rows import check_step


def test_iterative_step_matches_jax():
    check_step("newton")
