"""Host-side DSP ops: tap design, demod, quantized front end, FIR engine."""
