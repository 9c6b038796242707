"""3GPP NR constants used by the ported slice (values as in
``srsran_project_23_5_tpu/ran/constants.py``; TS 38.211/38.212)."""

NRE = 12                 # subcarriers per resource block
MAX_NSYMB_PER_SLOT = 14  # OFDM symbols per slot, normal cyclic prefix

LLR_MAX = 120            # largest LLR magnitude considered "soft"
LLR_INFTY = 127          # reserved magnitude meaning "surely known bit"

LDPC_BG1_K = 22
LDPC_BG2_K = 10
LDPC_MAX_SEG_BG1 = 8448
LDPC_MAX_SEG_BG2 = 3840

GOLD_NC = 1600           # Gold sequence offset Nc (TS 38.211 §5.2.1)
