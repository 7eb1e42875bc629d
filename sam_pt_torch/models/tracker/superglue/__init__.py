"""SuperPoint, SuperGlue and the SuperGlue point tracker (counterpart of
`sam_pt_tpu/models/tracker/superglue/`), and the `match_pairs` CLI."""
