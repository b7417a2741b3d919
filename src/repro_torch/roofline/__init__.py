"""Three-term roofline of the port's workloads on a hardware model
(`analysis`), from the aten ops a call dispatches (`op_count`)."""
