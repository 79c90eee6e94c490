"""Detection ops: boxes, anchors, NMS, proposals, PSROI pooling, warps."""
