"""ResNet backbone and FCGGNN head."""
