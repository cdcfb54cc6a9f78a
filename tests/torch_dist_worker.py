"""One rank of the port's two-rank CPU tests (gloo), spawned by
`dedark_yolo_tpu_torch.tools.dist_probe.launch` with torchrun's variables.

Usage: python tests/torch_dist_worker.py SCENARIO IN.npz OUT

    mesh  make_mesh, shard_batch, replicate and the object collectives
    bn    BatchNorm over the group on this rank's rows of IN's x: output,
          input gradient, weight gradients, running stats
    loss  the RT-DETR, segment and pose losses with the group's normalisers
          on this rank's rows of IN's inputs: total, items, gradients
    ranks the 'spatial' axis over the group's ranks (mesh (world // sp, sp),
          IN's sp, one slab a rank): the mesh's indices and subgroups, then on IN's
          map x (every rank the same) a 3x3 conv, a 5x5 max pool (its halo
          past a one-row neighbour), a mean and an amax over H x W and a
          join, and the gradients of a seeded cotangent to x and the conv's
          weight (summed over the spatial group), written by rank
    train YOLO.train of the tiny model on the dataset yaml IN under OUT/
          (argv[4]: full = two epochs, interrupt = stopped after epoch 0
          as a SIGTERM on this rank would, resume = resume=True)

Writes OUT_rank{r}.npz (OUT_rank{r}.json for mesh).
"""

import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dedark_yolo_tpu_torch.parallel import (  # noqa: E402
    init_from_env, make_mesh, replicate, shard_batch)
from dedark_yolo_tpu_torch.parallel import mesh as M  # noqa: E402

GROUP_TIMEOUT = 120      # a collective that does not match fails, not hangs


def rows(a, mesh):
    per = a.shape[0] // mesh.world
    return a[mesh.rank * per:(mesh.rank + 1) * per]


def scenario_mesh(z, mesh, out):
    r = mesh.rank
    batch = {"img": np.full((2, 4, 4, 3), r, np.uint8),
             "cls": np.arange(2, dtype=np.float32) + 10 * r}
    dev = shard_batch(mesh, batch)
    weights = {"w": torch.full((3, 2), float(r + 1)),
               "n": torch.arange(4) * (r + 1)}
    replicate(mesh, weights)
    sums = M.all_reduce_sum([torch.ones(3) * (r + 1),
                             torch.tensor([r], dtype=torch.int64)],
                            mesh.group)
    tss, b = M.global_sum(mesh.group, torch.tensor(1.5 * (r + 1)), 2)
    Path(f"{out}_rank{r}.json").write_text(json.dumps({
        "rank": r, "world": mesh.world, "device": str(mesh.device),
        "axis_names": list(mesh.axis_names), "shape": list(mesh.shape),
        "img": dev["img"].tolist(), "cls": dev["cls"].tolist(),
        "w": weights["w"].tolist(), "n": weights["n"].tolist(),
        "sums": [s.tolist() for s in sums], "tss": float(tss), "b": float(b),
        "gathered": M.gather_objects(mesh, {"rank": r}),
        "broadcast": M.broadcast_object(mesh, f"from {r}"),
        "rows": [M.rank_rows(n, mesh) for n in (4, 5, 1)]}))


def scenario_bn(z, mesh, out):
    from dedark_yolo_tpu_torch.nn.layers import BatchNorm, batchnorm_group
    c = z["x"].shape[1]
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(z["w"]))
        bn.bias.copy_(torch.from_numpy(z["b"]))
        bn.running_mean.copy_(torch.from_numpy(z["rm"]))
        bn.running_var.copy_(torch.from_numpy(z["rv"]))
    x = torch.from_numpy(rows(z["x"], mesh)).to(torch.float32)
    if str(z["dtype"]) == "bfloat16":    # amp: bf16 map and weights
        x = x.to(torch.bfloat16)
        bn.weight.data = bn.weight.data.to(torch.bfloat16)
        bn.bias.data = bn.bias.data.to(torch.bfloat16)
    x.requires_grad_(True)
    bn.train()
    with batchnorm_group(bn, mesh.group):
        y = bn(x)
        g = torch.from_numpy(rows(z["g"], mesh))
        dx, dw, db = torch.autograd.grad((y.float() * g).sum(),
                                         [x, bn.weight, bn.bias])
    assert bn.group is None
    np.savez(f"{out}_rank{mesh.rank}.npz", y=y.float().detach().numpy(),
             dx=dx.float().numpy(), dw=dw.float().numpy(),
             db=db.float().numpy(),
             rm=bn.running_mean.numpy(), rv=bn.running_var.numpy())


def scenario_loss(z, mesh, out):
    from dedark_yolo_tpu_torch.losses import rtdetr as TR
    from dedark_yolo_tpu_torch.losses import segment as TL
    res = {}
    t = lambda k: torch.from_numpy(rows(z[k], mesh))
    # RT-DETR: the outputs' batch dim is 1 (dec_*: (ndl, B, nq, .))
    dec_b = torch.from_numpy(_dec_rows(z["dec_bboxes"], mesh))
    dec_l = torch.from_numpy(_dec_rows(z["dec_logits"], mesh))
    enc_b, enc_l = t("enc_bboxes"), t("enc_logits")
    ins = [x.requires_grad_(True) for x in (dec_b, dec_l, enc_b, enc_l)]
    batch = {"cls": t("r_cls"), "bboxes": t("r_bboxes"),
             "mask_gt": t("r_mask_gt"),
             "recovery_loss": torch.tensor(float(z["r_rec"]) / mesh.world)}
    total, items = TR.rtdetr_loss(
        {"dec_bboxes": ins[0], "dec_logits": ins[1], "enc_bboxes": ins[2],
         "enc_logits": ins[3]}, batch, nc=int(z["nc"]), hyp={"lrl": 0.5},
        group=mesh.group)
    res.update(_pack("rtdetr", total, items, ins))
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5, "pose": 12.0, "kobj": 1.0}
    strides = [8, 16, 32]
    raw = [t(f"raw{i}").requires_grad_(True) for i in range(3)]
    coefs = [t(f"coef{i}").requires_grad_(True) for i in range(3)]
    protos = t("protos").requires_grad_(True)
    sb = {k: t(f"s_{k}") for k in ("cls", "bboxes", "mask_gt", "masks")}
    total, items = TL.segmentation_loss(
        raw, coefs, protos, sb, nc=int(z["nc"]), strides=strides, hyp=hyp,
        max_fg=16, overlap=True, group=mesh.group)
    res.update(_pack("segment", total, items, raw + coefs + [protos]))
    raw = [t(f"raw{i}").requires_grad_(True) for i in range(3)]
    kmaps = [t(f"kmap{i}").requires_grad_(True) for i in range(3)]
    pb = {k: t(f"p_{k}") for k in ("cls", "bboxes", "mask_gt", "keypoints")}
    total, items = TL.pose_loss(
        raw, kmaps, pb, nc=int(z["nc"]), strides=strides, hyp=hyp,
        kpt_shape=(3, 3), max_fg=16, group=mesh.group)
    res.update(_pack("pose", total, items, raw + kmaps))
    np.savez(f"{out}_rank{mesh.rank}.npz", **res)


def scenario_ranks(z, mesh, out):
    import torch.nn.functional as F
    from torch.distributed import get_process_group_ranks
    from dedark_yolo_tpu_torch.parallel import spatial as S
    sp = int(z["sp"])
    m = make_mesh(shape=(mesh.world // sp, sp), axes=("data", "spatial"),
                  device="cpu")
    info = {"spatial_index": m.spatial_index, "data_index": m.data_index,
            "data_size": m.data_size,
            "spatial_group": get_process_group_ranks(m.spatial_group),
            "data_group": (None if m.data_group is None
                           else get_process_group_ranks(m.data_group))}
    x = torch.from_numpy(z["x"]).requires_grad_(True)          # NHWC
    w = torch.from_numpy(z["w"]).requires_grad_(True)
    slab = S.rank_slab(x, m).permute(0, 3, 1, 2)
    y = F.max_pool2d(F.conv2d(slab, w, padding=1), 5, 1, 2)
    whole = y.join()
    red = y.mean((2, 3), keepdim=True) + y.amax((2, 3), keepdim=True)
    loss = ((whole * torch.from_numpy(z["g"])).sum()
            + (red * torch.from_numpy(z["gr"])).sum()) / m.spatial
    gx, gw = torch.autograd.grad(loss, [x, w])
    # each rank holds its share: summed over the spatial group
    gx, gw = (S._all_reduce(g, m.spatial_group) for g in (gx, gw))
    np.savez(f"{out}_rank{mesh.rank}.npz", y=whole.detach().numpy(),
             red=red.detach().numpy(), gx=gx.numpy(), gw=gw.numpy(),
             info=np.asarray(json.dumps(info)))


def _dec_rows(a, mesh):
    per = a.shape[1] // mesh.world
    return a[:, mesh.rank * per:(mesh.rank + 1) * per]


def _pack(name, total, items, inputs):
    grads = torch.autograd.grad(total, inputs, allow_unused=True)
    out = {f"{name}/total": total.detach().numpy(),
           f"{name}/items": torch.stack(list(items)).numpy()}
    for i, (g, x) in enumerate(zip(grads, inputs)):
        out[f"{name}/grad{i}"] = (torch.zeros_like(x) if g is None
                                  else g).numpy()
    return out


def train(data, out, mode):
    from dedark_yolo_tpu_torch import YOLO
    m = YOLO(str(Path(__file__).resolve().parent / "tiny_model.yaml"),
             device="cpu", seed=0)
    if mode == "interrupt":     # stop after epoch 0 (rank 1 only: the OR)
        m.add_callback("on_fit_epoch_end", lambda t: setattr(
            t, "_interrupted", t.mesh.rank == 1))
    metrics = m.train(data=data, epochs=2, imgsz=64, batch=2, workers=1,
                      device="cpu", plots=False, project=out, name="dist",
                      exist_ok=True, max_boxes=8, max_nms=64, max_det=10,
                      mesh_shape=[2], resume=mode == "resume")
    t = m.trainer
    Path(out, f"done_{mode}_rank{t.mesh.rank}.json").write_text(json.dumps({
        "metrics": {k: float(v) for k, v in metrics.items()},
        "epoch": t.epoch, "save_dir": str(t.save_dir),
        "device": str(t.device)}))


def main():
    scenario, inp, out = sys.argv[1:4]
    torch.set_num_threads(2)
    if scenario == "train":
        return train(inp, out, sys.argv[4])
    init_from_env(device="cpu",
                  timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    mesh = make_mesh(device="cpu")
    z = np.load(inp) if inp != "-" else None
    {"mesh": scenario_mesh, "bn": scenario_bn, "loss": scenario_loss,
     "ranks": scenario_ranks}[scenario](z, mesh, out)
    # every rank's collectives done before any rank tears the group down
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
