"""The example scripts of the PyTorch port, one per example of the JAX
package (examples/*.py), with the same file names and flags plus
`--device` (default: the CUDA card). Each is a `main(argv=None)`:

    python -m cube_slam_tpu_torch.examples.<name> [flags] [--device cpu]

They read images and draw overlays with PIL, imported inside `main`.
"""
