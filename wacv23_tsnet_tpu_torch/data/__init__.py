"""Host-side face geometry, and the on-device keypoint rasterizer
(`rasterize_device`)."""
