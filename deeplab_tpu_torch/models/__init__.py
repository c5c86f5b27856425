"""Model graphs of the port: MobileNetV2 trunk, DeepLabV3+ ASPP, SegNet."""
