"""Layers, flow net, encoders and alignment of the port (nn.Modules, NCHW)."""
