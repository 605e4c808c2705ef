"""slate_tpu_torch.examples (ex01-ex14, run_all), the port of examples/.

Each example holds itself against numpy and scipy, as the reference's do
(the reference's public drivers raise under the installed JAX, so its
examples' output is no oracle here).  They run in one process on the
serial grid, in a gloo world of four processes (2 x 2 grids), and ex01
and ex04 in a world of eight (2 x 4), with ex03 there on 2 x 2: the four
ranks past that grid sit it out.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import contextlib
import io

import pytest
import torch

from slate_tpu_torch.examples import run_all

import torch_dist_cases as cases
from torch_dist_worlds import run_world


def _passed(text: str, names) -> None:
    for name in names:
        assert f"== {name} ok" in text, (name, text[-2000:])
    assert f"{len(names)}/{len(names)} examples passed" in text


def test_run_all_in_one_process_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_all.main(["--device", "cpu"])
    _passed(buf.getvalue(), run_all.EXAMPLES)
    assert "grid 1x1" in buf.getvalue()


def test_run_all_in_a_gloo_world_of_4(tmp_path):
    ranks = run_world(4, cases.examples_body, (run_all.EXAMPLES,),
                      tmp_dir=str(tmp_path))
    assert [failed for failed, _ in ranks] == [[]] * 4
    _passed(ranks[0][1], run_all.EXAMPLES)
    assert "grid 2x2" in ranks[0][1]
    assert all(text == "" for _, text in ranks[1:])


def test_ex01_and_ex04_on_2x4_in_a_gloo_world_of_8(tmp_path):
    names = ["ex01_matrix", "ex04_norm", "ex03_submatrix"]
    ranks = run_world(8, cases.examples_body, (names,),
                      tmp_dir=str(tmp_path))
    assert [failed for failed, _ in ranks] == [[]] * 8
    _passed(ranks[0][1], names)
    assert "grid 2x4" in ranks[0][1]


def test_an_unknown_example_is_refused():
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit) as e:
        run_all.main(["ex99_nothing", "--device", "cpu"])
    assert e.value.code == 2


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_all.main(["ex01_matrix"])
