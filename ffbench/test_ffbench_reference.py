"""The plain references against Python integers, the comparison that
decides ``correct``, and the benchmark's independence from the JAX
package."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ffbench import check, gen
from ffbench.reference import bn254_fr_ntt as B
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
    for path in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in _imported_top_levels(path), path.name


# --- BN254: field elements of 8 words ------------------------------------------

RB = B.R


def _words(v: int) -> list[int]:
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def _value(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def _bn254_rows(d: int, seed: int) -> list[list[int]]:
    """Seeded rows of bucket d: uniform, the worst case (every coefficient
    r - 1), and a short row zero-padded to the bucket."""
    g = np.random.default_rng(seed)

    def uniform(n):
        return [int.from_bytes(g.bytes(32), "little") % RB for _ in range(n)]
    return [uniform(d), [RB - 1] * d, uniform(d - d // 3) + [0] * (d // 3)]


def _as_words(rows) -> torch.Tensor:
    return torch.tensor([[_words(v) for v in row] for row in rows],
                        dtype=torch.int64)


def _bigint_transform(row: list[int]) -> list[int]:
    d = len(row)
    omega = R.primitive_root(RB, d)
    powers = [pow(omega, k, RB) for k in range(d)]
    return [sum(a * powers[i * j % d] for i, a in enumerate(row)) % RB
            for j in range(d)]


@pytest.mark.parametrize("d", [64, 512])
def test_bn254_transform_equals_python_bigints(d):
    rows = _bn254_rows(d, d)
    y = B.transform(_as_words(rows), RB)
    assert y.shape == (len(rows), d, 8) and y.dtype == torch.int64
    for r, row in enumerate(rows):
        assert [_value(e) for e in y[r]] == _bigint_transform(row)


@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_bn254_omega_has_order_exactly_d(d):
    omega = R.primitive_root(RB, d)
    assert omega == pow(5, (RB - 1) // d, RB)
    assert pow(omega, d, RB) == 1 and pow(omega, d // 2, RB) != 1
    w = B.twiddles(d, RB)
    assert sum(int(v) << (16 * k) for k, v in enumerate(w[1, 1])) == omega


def test_bn254_control_in_float32_comes_out_wrong():
    g = torch.Generator().manual_seed(4)
    cfg = {"modulus": str(RB), "reference": "bn254_fr_ntt",
           "coefficients": {"words": 8}}
    src = gen.uniform_words(RB, 8, 16 * 64, g, "cpu").numpy().astype(
        np.uint32).reshape(16, 64, 8)
    ans = [(c, None) for c in src]
    assert check.compare(ans, cfg, "cpu", control=torch.float32) == 16
    assert check.compare(ans, cfg, "cpu", control=torch.float64) == 0


def test_compare_takes_element_rows(bn254_config):
    """Drawn by the generator, compared by ``check.compare``: right rows
    read 0, one flipped word 1, a row of one word an element wrong."""
    src = gen.RequestSource(bn254_config, 2**31 + 5, "window", chunk=8,
                            degrees=[300] * 8)
    coeffs = [src.get(i)[1] for i in range(8)]
    padded = np.zeros((8, 512, 8), np.int64)
    for k, c in enumerate(coeffs):
        padded[k, :len(c)] = c
    rows = B.transform(torch.from_numpy(padded), RB).numpy().astype(np.uint32)
    assert [_value(e) for e in rows[0]] == _bigint_transform(
        [_value(c) for c in padded[0]])
    ans = list(zip(coeffs, rows))
    assert check.compare(ans, bn254_config, "cpu") == 0
    flipped = rows[3].copy()
    flipped[100, 5] ^= 1 << 7
    ans[3] = (coeffs[3], flipped)
    assert check.compare(ans, bn254_config, "cpu") == 1
    ans[3] = (coeffs[3], rows[3][:, 0])          # (b,): no element shape
    assert check.compare(ans, bn254_config, "cpu") == 1
    ans[3] = (coeffs[3], rows[3][:256])          # another bucket's length
    assert check.compare(ans, bn254_config, "cpu") == 1


@pytest.mark.chip
def test_bn254_transform_on_card_equals_python_bigints(cuda_device):
    for d in (64, 512):
        rows = _bn254_rows(d, d + 1)
        x = _as_words(rows)
        y = B.transform(x.to(cuda_device), RB).cpu()
        for r, row in enumerate(rows):
            assert [_value(e) for e in y[r]] == _bigint_transform(row)
        # and a larger block equal to the CPU's, row for row
        big = gen.uniform_words(RB, 8, 64 * d, torch.Generator().manual_seed(d),
                                "cpu").reshape(64, d, 8)
        assert torch.equal(B.transform(big.to(cuda_device), RB).cpu(),
                           B.transform(big, RB))
