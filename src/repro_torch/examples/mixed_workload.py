"""Heterogeneous co-scheduling (paper §7.4) and the zone-separation audit.

    PYTHONPATH=src python -m repro_torch.examples.mixed_workload [--device cpu]

* Dilithium and BN254 batches dispatched together through Tier 2
  (``dispatch_mixed``), each class one captured program on the card;
* one mixed-precision program (a Dilithium transform, then work in the
  BN254 zones) validated: each zone's kernels apart, nothing read across;
* a program that breaks the separation, flagged.  The JAX example shows
  XLA fusing two zones' ops into one; the card has no fusing compiler, so
  here the breach is the one the validator's tests build: a fold in the
  BN254 zone that reads what a GEMM of the Dilithium zone wrote (V3), found
  in the captured graph (on the CPU, in the launch log).
"""
import numpy as np
import torch

from repro_torch.core import field as F
from repro_torch.core import limb_gemm as G
from repro_torch.core import ntt as NTT
from repro_torch.core import rns as R
from repro_torch.core import validator as V
from repro_torch.core import workloads as WK
from repro_torch.core import zones as Z
from repro_torch.core.scheduler import RectangularScheduler, TenantRequest
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.device import resolve_device
from repro_torch.examples import check, parser
from repro_torch.kernels.mont_fold.ops import mont_fold


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- concurrent heterogeneous dispatch -----------------------------------
    cos = SliceCoScheduler(device=dev)
    dil_reqs = [TenantRequest(i, "dilithium", 256, 0.0, np.asarray(
        rng.integers(0, 8380417, 256, dtype=np.uint64), np.uint32))
                for i in range(4)]
    chain = R.make_chain(9)
    bn_reqs = []
    for i in range(2):
        vals = np.array([int(x) for x in rng.integers(0, 2**31, 64)], object)
        bn_reqs.append(TenantRequest(100 + i, "bn254", 64, 0.0,
                                     R.to_rns_np(vals, chain)))
    sched = RectangularScheduler(n_c=4, bucket_granularity=64)
    results = cos.dispatch_mixed(sched.plan_batches(dil_reqs + bn_reqs))
    workloads = [r.batch.workload for r in results]
    check(sorted(set(workloads)) == ["bn254", "dilithium"]
          and sum(len(r.outputs) for r in results) == 6,
          f"dispatch_mixed served {workloads}")
    oracle = WK.DilithiumEngine(256, device="cpu")
    for r in dil_reqs:
        got = next(res.outputs[r.tenant_id] for res in results
                   if r.tenant_id in res.outputs)
        check(np.array_equal(got, oracle.oracle_np(r.coeffs[None])[0]),
              f"tenant {r.tenant_id} differs from the bignum oracle")
    print(f"co-scheduled {len(results)} heterogeneous batches on {dev}: "
          f"{workloads}, Dilithium rows == bignum oracle ✓")

    # --- separated mixed program passes validation ---------------------------
    dil = WK.DilithiumEngine(256, device=dev)

    def separated(a, b):
        y1 = dil.e2e(a)
        with Z.workload_zone("bn254", dev), Z.precision_zone(4, dev):
            y2 = b * 3
        return y1, y2

    zeros = torch.zeros((4, 256), dtype=torch.int32, device=dev)
    rep = V.validate_fn(separated, zeros, zeros.clone(),
                        expected_passes=dil.n_passes)
    rep.raise_if_failed()
    print(f"separated mixed program: validation PASSED "
          f"(zones={sorted(rep.zones)}, fold → next-GEMM paths="
          f"{rep.n_barriers}) ✓")

    # --- a fold in another zone than its GEMM: the validator aborts ----------
    plan = G.make_channel_plan(
        NTT.ntt_matrix(64, F.DILITHIUM_Q, negacyclic=True), F.DILITHIUM_Q,
        data_limbs=3, tw_limbs=3)
    _, fused = G.plane_operands(plan, dev)

    def cross_zone(x):
        with Z.workload_zone("dilithium", dev), Z.precision_zone(3, dev):
            diag = G.tile_diagonals(x, None, fused, plan)
        with Z.workload_zone("bn254", dev), Z.precision_zone(3, dev):
            return mont_fold(diag, F.DILITHIUM_Q)

    rep2 = V.validate_fn(cross_zone,
                         torch.zeros((2, 64), dtype=torch.int32, device=dev),
                         expect_eager=False)
    codes = sorted({v[0] for v in rep2.violations})
    check(not rep2.ok and codes == ["V3"],
          f"the cross-zone program gave {rep2.violations}")
    where = ("its captured graph" if rep2.graph is not None
             else "its launch log")
    print(f"cross-zone program: validator ABORTS dispatch with {codes}, "
          f"found in {where}:\n   {rep2.violations[0][1][:120]}")
    return {"device": str(dev), "batches": len(results),
            "workloads": workloads, "separated_ok": rep.ok,
            "cross_zone_codes": codes,
            "validated_from": "graph" if rep2.graph is not None else "log",
            "ok": True}


if __name__ == "__main__":
    main()
