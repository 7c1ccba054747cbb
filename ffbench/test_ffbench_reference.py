"""The plain reference against Python integers, and the benchmark's
independence from the JAX package."""
import ast
from pathlib import Path

import pytest
import torch

from ffbench import check
from ffbench.reference import negacyclic_ntt as R

Q = 8380417
HERE = Path(__file__).resolve().parent


def test_psi_at_256_is_the_documented_root():
    assert R.primitive_root(Q, 512) == 6757063


@pytest.mark.parametrize("d", [64, 128])
def test_transform_equals_direct_evaluation(d):
    x = torch.randint(0, Q, (3, d), generator=torch.Generator().manual_seed(d))
    y = R.transform(x, Q)
    psi = R.primitive_root(Q, 2 * d)
    for r in range(3):
        a = [int(v) for v in x[r]]
        want = [sum(a[i] * pow(psi, i * (2 * j + 1), Q) for i in range(d)) % Q
                for j in range(d)]
        assert [int(v) for v in y[r]] == want


def test_transform_turns_negacyclic_convolution_into_products():
    d = 64
    g = torch.Generator().manual_seed(1)
    a, b = (torch.randint(0, Q, (d,), generator=g) for _ in range(2))
    conv = [0] * d
    for i in range(d):
        for j in range(d):
            k, s = (i + j) % d, (1 if i + j < d else -1)
            conv[k] = (conv[k] + s * int(a[i]) * int(b[j])) % Q
    fa, fb, fc = R.transform(torch.stack([a, b, torch.tensor(conv)]), Q)
    assert torch.equal(fa * fb % Q, fc)


def test_zero_padding_to_the_bucket():
    d = 100
    x = torch.randint(0, Q, (2, d), generator=torch.Generator().manual_seed(2))
    padded = torch.zeros((2, 128), dtype=torch.int64)
    padded[:, :d] = x
    ans = [(x[r].numpy().astype("uint32"),
            R.transform(padded, Q)[r].numpy().astype("uint32"))
           for r in range(2)]
    assert check.compare(ans, {"modulus": Q, "reference": "negacyclic_ntt"},
                         "cpu") == 0


def test_control_in_float32_comes_out_wrong():
    """The control: the reference one precision lower in the program's
    place; every row of a d = 256 batch reads wrong."""
    g = torch.Generator().manual_seed(3)
    ans = [(torch.randint(0, Q, (256,), generator=g).numpy().astype("uint32"),
            None) for _ in range(64)]
    cfg = {"modulus": Q, "reference": "negacyclic_ntt"}
    assert check.compare(ans, cfg, "cpu", control=torch.float32) == 64
    assert check.compare(ans, cfg, "cpu", control=torch.float64) == 0


def _imported_top_levels(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    found = _imported_top_levels(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path.name} imports {found}"


def test_reference_imports_nothing_of_the_program():
    assert "repro_torch" not in _imported_top_levels(
        HERE / "reference" / "negacyclic_ntt.py")
