"""MXInt format types, LUT builders and the block quantizer."""
