"""Demo: the full RRC attach flow over exact TS 38.331 UPER encodings.

Prints every control-plane message the attach exchanges — the UL-CCCH
RRCSetupRequest (the canonical 6 octets), the DL-CCCH RRCSetup carrying
the DU-manager-allocated dedicated PUCCH resources inside its
masterCellGroup container, the DCCH security/reconfiguration handshake
— plus the NGAP/F1AP PDUs in their 3GPP PDU/IE-container APER framing.
Host code only: it prints what ``examples/rrc_attach_demo.py`` prints.

    python -m srsran_project_23_5_tpu_torch.examples.rrc_attach_demo
"""
from __future__ import annotations

import argparse

from .. import asn1, rrc
from ..du_manager import DuUeManager
from ..ngap import NgSetupRequest
from ..rrc import messages_38331 as m38331
from ..scheduler.config import CellConfig


def show(name: str, data: bytes) -> None:
    print(f"  {name:34s} {len(data):4d} B  {data[:16].hex()}"
          f"{'…' if len(data) > 16 else ''}")


def main(argv: list[str] | None = None) -> dict:
    """Run the attach; returns {"messages": {name: bytes}, "gnb_state",
    "ue_drbs"}.  Raises if the UE's parsed SR resource is not the DU
    manager's or the gNB side does not end ACTIVE."""
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    sent: dict[str, bytes] = {}

    def record(name: str, data: bytes) -> None:
        sent[name] = data
        show(name, data)

    print("== NGAP (ALIGNED PER, NGAP-PDU framing) ==")
    record("NGSetupRequest (proc=21)", asn1.encode(NgSetupRequest()))

    print("== DU manager: pooled PUCCH resources for one UE ==")
    cell = CellConfig(nof_prb=52)
    mgr = DuUeManager(cell)
    res = mgr.create_ue(0x4601, due_id=1)
    a = res.pucch
    print(f"  SR  resource: PRB {a.sr.resource.prb} CS "
          f"{a.sr.resource.initial_cyclic_shift} every "
          f"{a.sr.period_slots} slots @ offset {a.sr.offset}")
    print(f"  CSI resource: PRB {a.csi.resource.prb_start} every "
          f"{a.csi.period_slots} slots @ offset {a.csi.offset}")

    print("== RRC attach (UNALIGNED PER, exact 38.331) ==")
    dl_q, ul_q = [], []
    ue = rrc.RrcUeSide(send_ul=ul_q.append)
    gnb = rrc.RrcUe(0, send_dl=dl_q.append)

    msg3 = ue.connect(b"\x00\x00\xaa\xbb\xcc\xdd", b"nas-registration")
    record("RRCSetupRequest (UL-CCCH, Msg3)", msg3)
    cg = m38331.encode_cell_group({
        "cellGroupId": 0,
        "rlc-BearerToAddModList": [{
            "logicalChannelIdentity": 1,
            "servedRadioBearer": ("srb-Identity", 1)}],
        "spCellConfig": m38331.build_sp_cell_config(
            sr={"res_id": a.sr.resource.res_id, "prb": a.sr.resource.prb,
                "cs": a.sr.resource.initial_cyclic_shift,
                "period_slots": a.sr.period_slots, "offset": a.sr.offset},
            csi={"res_id": a.csi.resource.res_id,
                 "prb": a.csi.resource.prb_start,
                 "nof_prb": a.csi.resource.nof_prb,
                 "period_slots": a.csi.period_slots,
                 "offset": a.csi.offset})})
    gnb.handle_setup_request(rrc.decode_setup_request(msg3),
                             du_cell_group=cg)
    record("RRCSetup (DL-CCCH, w/ PUCCH cfg)", dl_q[-1])
    ue.handle_dl_message(dl_q.pop())
    record("RRCSetupComplete (UL-DCCH)", ul_q[-1])
    gnb.handle_ul_message(ul_q.pop())
    sr_cfg, csi_cfg = ue.pucch_cfg
    print(f"  UE parsed dedicated config: SR PRB {sr_cfg['prb']} CS "
          f"{sr_cfg['cs']} sl{sr_cfg['period_slots']}@{sr_cfg['offset']}")
    if sr_cfg["prb"] != a.sr.resource.prb:
        raise AssertionError(f"the UE parsed SR PRB {sr_cfg['prb']}, the "
                             f"DU manager gave {a.sr.resource.prb}")

    gnb.start_security(b"\x07" * 32)
    record("SecurityModeCommand (DL-DCCH)", dl_q[-1])
    ue.handle_dl_message(dl_q.pop())
    record("SecurityModeComplete (UL-DCCH)", ul_q[-1])
    gnb.handle_ul_message(ul_q.pop())

    gnb.reconfigure([rrc.DrbConfig(drb_id=1, lcid=4)], [b"nas-accept"])
    record("RRCReconfiguration (DL-DCCH)", dl_q[-1])
    ue.handle_dl_message(dl_q.pop())
    record("RRCReconfigurationComplete", ul_q[-1])
    gnb.handle_ul_message(ul_q.pop())
    drbs = [(d.drb_id, d.lcid) for d in ue.drbs]
    print(f"  gNB state: {gnb.state}; UE DRBs: {drbs}")
    if gnb.state != rrc.RrcUeState.ACTIVE:
        raise AssertionError(f"the gNB side ended in {gnb.state}")
    return {"messages": sent, "gnb_state": gnb.state, "ue_drbs": drbs}


if __name__ == "__main__":
    main()
