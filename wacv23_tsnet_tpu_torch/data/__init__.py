"""Host-side face data: the PNG codec and resizes (`image_io`), the
landmark rasterizer and crops (`face`, `rasterize`), the photometric
jitter (`augment`), the training dataset and loader (`datasets`,
`loader`); and the on-device keypoint rasterizer (`rasterize_device`)."""
