"""Reconstruct prostate T2 / DWI cases.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/recon.py:21-77``
(``reconstruct_case``, ``main``), after the prostate code's
``fastmri_prostate_recon.py``: walk ``{data_path}/{split}/{T2,DIFFUSION}``,
reconstruct each ``.h5`` case with the GRAPPA pipelines and save the result
``.h5`` under the output path, with the same flags, plus ``--device``
(default ``cuda``, which raises without a card). ``--data-parallel N``
spreads each case's GRAPPA hole-fill over ``N`` devices
(``parallel/mesh.py:mesh_devices``: ``N`` cards, or ``N`` CPU devices
with ``--device cpu``), raising as JAX's ``make_mesh`` does where the cards
are fewer. Reading and writing ``.h5`` needs h5py.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.recon \\
      --data-path /data/prostate --output-path recons \\
      --sequence t2 --split training
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.recon_data import load_file_dwi, load_file_T2, save_recon
from ..parallel.mesh import mesh_devices
from ..recon import dwi_reconstruction, t2_reconstruction


def reconstruct_case(fname: str, sequence: str, mesh=None,
                     transfer_dtype=None, device: str = "cuda") -> dict:
    """The reconstruction of one T2 or DWI case file, on ``device``."""
    if sequence == "t2":
        kspace, calib, hdr, _, _ = load_file_T2(fname)
        return t2_reconstruction(kspace, calib, hdr, mesh=mesh,
                                 transfer_dtype=transfer_dtype,
                                 device=device)
    kspace, calib, coil_sens, hdr = load_file_dwi(fname)
    return dwi_reconstruction(kspace, calib, coil_sens, hdr, mesh=mesh,
                              transfer_dtype=transfer_dtype, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("Reconstruct prostate T2/DWI cases")
    p.add_argument("--data-path", type=Path, required=True)
    p.add_argument("--output-path", type=Path, required=True)
    p.add_argument("--sequence", choices=["t2", "dwi"], required=True)
    p.add_argument("--split", default="training",
                   choices=["training", "validation", "test"])
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard each case's slices over N devices "
                        "(slices are independent)")
    p.add_argument("--transfer-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16 halves the bulk k-space upload bytes; "
                        "the calibration and weight solves stay f32 (about "
                        "0.4%% relative, see recon/t2.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda or cpu; cuda raises without a card.")
    args = p.parse_args(argv)
    mesh = None
    if args.data_parallel > 1:
        mesh = mesh_devices(args.data_parallel, args.device)

    sub = "T2" if args.sequence == "t2" else "DIFFUSION"
    case_dir = args.data_path / args.split / sub
    if not case_dir.is_dir():
        p.error(f"no such dir: {case_dir}")
    args.output_path.mkdir(parents=True, exist_ok=True)

    n = 0
    for fname in sorted(case_dir.iterdir()):
        if fname.suffix != ".h5":
            continue
        print(f"[recon] {fname.name} ({args.sequence})")
        out = reconstruct_case(str(fname), args.sequence, mesh=mesh,
                               transfer_dtype=args.transfer_dtype,
                               device=args.device)
        save_recon(out, str(args.output_path / fname.name))
        n += 1
    print(f"[recon] reconstructed {n} case(s) -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
