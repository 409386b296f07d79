"""The port's KV-cache writers as they were before the writes went in
place: functional versions that return new cache tensors (a gather and a
select for the dense caches, a scatter into a copy of the arena with a
spare row for the paged ones). The tests hold the in-place writers of
``repro_torch.models.attention`` to them bit for bit, alone and inside
whole serving runs (:func:`use_functional_writers`)."""
import torch

from repro_torch.models import attention as attn


def write_kv(cache, k_new, v_new, pw, slots, kvq=None):
    """New dense cache with the (B, T) tokens written at ``slots``; slots
    equal to S (dead cells) write nothing."""
    B, S = cache.pos.shape
    hit = slots[:, :, None] == torch.arange(S, device=slots.device)
    has = hit.any(dim=1)                                 # (B, S)
    src = hit.int().argmax(dim=1)                        # (B, S) token index

    def put(old, new):
        tail = (1,) * (old.dim() - 2)
        idx = src.reshape(B, S, *tail).expand(B, S, *old.shape[2:])
        gathered = torch.gather(new.to(old.dtype), 1, idx)
        return torch.where(has.reshape(B, S, *tail), gathered, old)

    if isinstance(cache, attn.QuantKVCache):
        kq, ks, vq, vs = attn._quantize_kv_writes(cache, k_new, v_new, kvq)
        return type(cache)(k_q=put(cache.k_q, kq), v_q=put(cache.v_q, vq),
                           k_s=put(cache.k_s, ks), v_s=put(cache.v_s, vs),
                           pos=put(cache.pos, pw.to(cache.pos.dtype)))
    return attn.KVCache(k=put(cache.k, k_new), v=put(cache.v, v_new),
                        pos=put(cache.pos, pw.to(cache.pos.dtype)))


def write_paged_kv(cache, k_new, v_new, pw, block_table, window, kvq=None):
    """New arena with the (B, T) tokens written through the block table;
    dead cells and unmapped blocks land on a spare row that is cut off."""
    num_blocks, bs = cache.pos.shape
    s_cap = attn.paged_capacity(block_table, bs, window)
    L = torch.remainder(torch.clamp_min(pw, 0), s_cap)
    phys = torch.gather(block_table, 1, (L // bs).long())
    dead = (pw < 0) | (phys < 0)
    flat = torch.where(dead, num_blocks * bs, phys * bs + L % bs)
    flat = flat.reshape(-1).long()

    def put(arena, new):
        rows = arena.reshape(num_blocks * bs, *arena.shape[2:])
        rows = torch.cat([rows, rows[:1]]).index_copy(
            0, flat, new.reshape(flat.shape[0], *arena.shape[2:]).to(
                arena.dtype))
        return rows[:-1].reshape(arena.shape)

    pos = put(cache.pos, pw)
    if isinstance(cache, attn.PagedQuantKVCache):
        kq, ks, vq, vs = attn._quantize_kv_writes(cache, k_new, v_new, kvq)
        return type(cache)(k_q=put(cache.k_q, kq), v_q=put(cache.v_q, vq),
                           k_s=put(cache.k_s, ks), v_s=put(cache.v_s, vs),
                           pos=pos)
    return attn.PagedKVCache(k=put(cache.k, k_new), v=put(cache.v, v_new),
                             pos=pos)


def _into(cache, new):
    for dst, src in zip(cache, new):
        dst.copy_(src)
    return cache


def use_functional_writers(monkeypatch):
    """Serve through the functional writers: each write is computed as a
    new cache, then copied into the cache the step holds (the step relies
    on its cache being written). Whole caches only: a rank's slice of a
    sequence-sharded cache (``shard``) has no functional twin here."""
    def whole(shard):
        if tuple(shard) != (0, 1):
            raise NotImplementedError("the functional writers write whole "
                                      f"caches, not shard {shard}")

    def dense(c, k, v, pw, window, kvq=None, plans=None, shard=(0, 1)):
        whole(shard)
        slots = attn._write_slots(pw, c.pos.shape[1], window)
        return _into(c, write_kv(c, k, v, pw, slots, kvq))

    def paged(c, *a, plans=None, shard=(0, 1)):
        whole(shard)
        return _into(c, write_paged_kv(c, *a))
    monkeypatch.setattr(attn, "_write_kv", dense)
    monkeypatch.setattr(attn, "_write_paged_kv", paged)
