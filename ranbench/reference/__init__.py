"""The benchmark's plain reference, which imports nothing of the program
(no CUDA kernel, no captured graph) and sits here so that a later change to
the program cannot move the yardstick.

Written for the benchmark, from the specification or from the JAX package's
definitions, in float64, sharing no code with the port: the OFDM modulator
and demodulator (``phy/lower/ofdm``), the constellation mapper and max-log
demapper (``ops/modulation``), the channel estimators (``ops/estimator``),
the zero-forcing equaliser (``ops/equalizer``), the PUCCH format 1 detector
and the PRACH detector.

Copied from the port's plain PyTorch code, each file saying so: the sizes
and tables, the transmit chains, rate matching and segmentation, CRC, the
plain LDPC encoder and layered min-sum decoder, polar and short-block
coding, the SSB, PDCCH and CSI-RS processors, the FAPI translation and the
slot models.  The spec tables (TS 38.212) are a copy in ``data/``.
"""
