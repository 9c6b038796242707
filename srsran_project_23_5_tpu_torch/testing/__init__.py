"""In-framework test doubles (the reference tests against srsUE /
spies; these emulators close the loop without external software)."""
from .ue_emulator import UeEmulator

__all__ = ["UeEmulator"]
