"""Plain PyTorch reference of TS-Net, independent of the measured package."""
