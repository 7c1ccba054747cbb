"""Quickstart: the paper's core objects on the port, in four steps.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Exact Dilithium NTT through the staged limb pipeline (3-limb u8×s8,
   fp32-mantissa staging at d_max = 171: two passes for d = 256), every
   GEMM the K1 kernel and every fold K2, against the bignum oracle.
2. BN254 ERNS evaluation + Montgomery reduction (9 channels, in-envelope).
3. The accumulator exactness probes (paper Table 1), one K1 call each: on
   the card the row reads K1's order of summation, which differs from the
   JAX package's row at 2**28 and 2**30; on the CPU it is the plain
   version's row, which equals the JAX package's.
4. Structural validation of the captured program: on the card the graph of
   one capture, node by node (on the CPU the launch log).  ``n_barriers``
   counts the fold → next-GEMM paths there, the port's counterpart of the
   JAX package's ``optimization_barrier``s.
"""
import numpy as np
import torch

from repro_torch.core import accumulator as ACC
from repro_torch.core import validator as V
from repro_torch.core import wordarith as W
from repro_torch.core import workloads as WK
from repro_torch.device import resolve_device
from repro_torch.examples import check, parser


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    # 1 — Dilithium forward NTT through the staged limb pipeline
    eng = WK.DilithiumEngine(256, device=dev)
    print(f"Dilithium d=256: {eng.n_passes} staging passes "
          f"(d_max={eng.plan.d_max}, paper: 171+85) on {dev}")
    rng = np.random.default_rng(0)
    a = np.asarray(rng.integers(0, 8380417, (4, 256), dtype=np.uint64),
                   np.uint32)
    y = eng.evaluate(a).cpu().numpy().astype(np.uint32)
    check(np.array_equal(y, eng.oracle_np(a)),
          "Dilithium forward NTT differs from the bignum oracle")
    print("   forward NTT == bignum oracle for all 4 tenant rows ✓")

    # 2 — BN254: 9-channel ERNS + Shenoy–Kumaresan/Montgomery reduction
    d = 32
    omega = np.array([[int.from_bytes(rng.bytes(11), "little")
                       for _ in range(d)] for _ in range(d)], object)
    bn = WK.BN254Engine(d, evaluation_matrix=omega, device=dev)
    coeffs = np.array([[int.from_bytes(rng.bytes(16), "little")
                        for _ in range(d)] for _ in range(2)], object)
    digits = bn.e2e(bn.ingest(coeffs)).cpu().numpy()
    want = bn.oracle_eval_np(coeffs) % bn.chain.p
    check(all(W.digits_to_int(digits[i, j]) == want[i, j]
              for i in range(2) for j in range(d)),
          "BN254 e2e differs from the bignum evaluation")
    print(f"   BN254 e2e op (144 pointwise cross-products + "
          f"Montgomery reduction) exact in the {bn.chain.M.bit_length()}-bit "
          f"CRT envelope ✓")

    # 3 — Table 1 accumulator probes, one K1 call each
    rows = ACC.table1_rows(device=dev)
    fp32, int32 = rows["tpu_v4_fp32_mantissa"], rows["tpu_v5_int32_native"]
    check(all(int32) and fp32[:5] == [True, True, True, False, False],
          f"Table 1: fp32 {fp32}, int32 {int32}")
    whose = ("K1's row on the card (its fp32 order of summation decides "
             "2**28 and 2**30)" if on_card
             else "the plain version's row on the CPU (the JAX package's)")
    print(f"   accumulator probes, {whose}: fp32={fp32} int32={int32}")

    # 4 — structural validation of the captured program
    rep = V.validate_fn(eng.e2e, torch.as_tensor(a.astype(np.int64),
                                                  device=dev),
                        expected_passes=eng.n_passes)
    rep.raise_if_failed()
    where = ("the captured graph" if rep.graph is not None
             else "the launch log")
    print(f"   structural validator: {rep.n_barriers} fold → next-GEMM "
          f"paths in {where} (the port's barriers), Invariant 5.1 holds, "
          f"zones={sorted(rep.zones)} ✓")
    return {"device": str(dev), "dilithium_rows": len(a), "bn254_rows": 2,
            "table1": rows, "n_barriers": rep.n_barriers,
            "validated_from": "graph" if rep.graph is not None else "log",
            "ok": True}


if __name__ == "__main__":
    main()
