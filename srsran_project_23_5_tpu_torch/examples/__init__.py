"""The port's counterparts of ``examples/`` at the repository root, each a
module with ``main(argv=None)`` that returns a small result dict:

    python -m srsran_project_23_5_tpu_torch.examples.rrc_attach_demo
    python -m srsran_project_23_5_tpu_torch.examples.radio_ssb
    python -m srsran_project_23_5_tpu_torch.examples.phy_loopback
    python -m srsran_project_23_5_tpu_torch.examples.mixed_slot_demo

The PHY examples run on the current CUDA device unless ``--device`` names
another (``--device cpu`` runs the plain versions); without a card and
without ``--device`` they raise.
"""
