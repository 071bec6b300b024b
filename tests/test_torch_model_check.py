"""The port's copy of the protocol model checker
(``poseidon_tpu_torch/analysis/model_check.py``) against the JAX
package's.

The port's async tier speaks the JAX package's protocol, so the same
model must check it: for every ``smoke_configs()`` entry the port's
checker explores the JAX checker's states and transitions exactly and
gives its verdict, and every seeded mutation is caught. Tolerance: exact
counts.
"""

import pytest

from poseidon_tpu.analysis import model_check as JM

from poseidon_tpu_torch.analysis import model_check as M
from poseidon_tpu_torch.analysis.__main__ import main


@pytest.fixture(scope="module")
def both():
    return M.run_level("smoke"), JM.run_level("smoke")


def test_smoke_configs_match_jax_state_for_state(both):
    (ours, caught), (theirs, jcaught) = both
    assert [c.name for c in M.smoke_configs()] == \
        [c.name for c in JM.smoke_configs()]
    assert [(r.config.name, r.states, r.transitions, r.ok) for r in ours] \
        == [(r.config.name, r.states, r.transitions, r.ok) for r in theirs]
    assert all(r.ok for r in ours)
    assert caught == jcaught


def test_every_seeded_mutation_is_caught(both):
    (_, caught), _ = both
    assert caught and all(caught.values()), caught
    assert set(caught) == set(M.MUTATIONS)


def test_the_copy_imports_nothing_of_the_jax_package():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(M))
    roots = {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)} | {
        a.name.split(".")[0] for n in ast.walk(tree)
        if isinstance(n, ast.Import) for a in n.names}
    assert not roots & {"jax", "poseidon_tpu", "torch"}, roots


def test_cli_model_check_tiny_and_a_bad_level(capsys, tmp_path):
    clean = tmp_path / "clean.py"      # lint only this file
    clean.write_text("X = 1\n")
    assert main(["--model-check", "tiny", str(clean)]) == 0
    assert "mutation self-test" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["--model-check", "huge", str(clean)])
    assert e.value.code == 3
