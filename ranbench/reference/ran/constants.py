"""3GPP NR constants used by the ported slice (values as in

Copied from the port's ``srsran_project_23_5_tpu_torch/ran/constants.py``,
unchanged.

``srsran_project_23_5_tpu/ran/constants.py``; TS 38.211/38.212)."""

NRE = 12                 # subcarriers per resource block
MAX_RB = 275             # maximum resource blocks per carrier (FR1+FR2)
MAX_PORTS = 16           # maximum antenna ports handled by the PHY
MAX_NSYMB_PER_SLOT = 14  # OFDM symbols per slot, normal cyclic prefix

LLR_MAX = 120            # largest LLR magnitude considered "soft"
LLR_INFTY = 127          # reserved magnitude meaning "surely known bit"

LDPC_BG1_M = 46          # BG1 check nodes (base rows)
LDPC_BG1_N_FULL = 68     # BG1 variable nodes before shortening
LDPC_BG1_K = 22          # BG1 message columns (K = 22*Zc)
LDPC_BG2_M = 42
LDPC_BG2_N_FULL = 52
LDPC_BG2_K = 10
LDPC_MAX_LIFTING_SIZE = 384
LDPC_MAX_MESSAGE_SIZE = LDPC_BG1_K * LDPC_MAX_LIFTING_SIZE      # 8448
LDPC_MAX_CODEBLOCK_SIZE = 66 * LDPC_MAX_LIFTING_SIZE            # 25344
LDPC_MAX_SEG_BG1 = 8448
LDPC_MAX_SEG_BG2 = 3840

POLAR_NMAX_LOG = 10      # TS 38.212 §5.3.1
POLAR_NMAX = 1 << POLAR_NMAX_LOG

PRACH_LONG_SEQ_LEN = 839     # Zadoff-Chu lengths (TS 38.211 §6.3.3.1)
PRACH_SHORT_SEQ_LEN = 139

GOLD_NC = 1600           # Gold sequence offset Nc (TS 38.211 §5.2.1)
