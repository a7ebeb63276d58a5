"""Models of the separation path: U-Net with CoLoc fusion, ResNet18 frame
encoders, builder and the JAX weight converter."""
