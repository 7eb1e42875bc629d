"""The user tools of the repo's `scripts/` that read and draw on the host
(no device): `annotation_comparison_gif` and
`visualize_point_sampling_methods`, each run as
`python -m sam_pt_torch.tools.<name> --help`."""
