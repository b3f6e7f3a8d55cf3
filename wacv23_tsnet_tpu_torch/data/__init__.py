"""Host-side data: the PNG codec, the JPEG decoder and the resizes
(`image_io`, `jpeg`), the label codecs (`codecs`), the face landmark and
OpenPose rasterizers and crops (`face`, `rasterize`), pose retargeting
(`posenorm`), keypoint smoothing (`smoothing`), the photometric jitter
(`augment`), the face and pose datasets and the loader (`datasets`,
`loader`), the GIF writer (`gif`); and the on-device keypoint
rasterizers (`rasterize_device`)."""
