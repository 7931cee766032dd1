"""Client-facing pub/sub + keyspace notifications (server/resp.py).

The reference inherits SUBSCRIBE/PSUBSCRIBE and __keyspace@N__ events from
valkey-server (valkey notify.c/pubsub.c) and *consumes* the events to
drive indexing; this standalone stack carries the client surface itself,
so an off-the-shelf client ecosystem (CDC listeners, cache invalidation)
finds the channels it expects ."""

import time

import pytest

from valkey_search_tpu.runtime import config
from valkey_search_tpu.server.resp import RespServer

from tests.test_resp_server import RespClient, ReplyError


@pytest.fixture()
def server():
    srv = RespServer(port=0)
    srv.start()
    yield srv
    srv.close()
    config.REGISTRY.reset_all()


@pytest.fixture()
def client(server):
    c = RespClient(server.port)
    yield c
    c.close()


def sub_client(server, *chans, pattern=False, proto=2):
    c = RespClient(server.port)
    if proto == 3:
        c.cmd("HELLO", "3")
    for i, ch in enumerate(chans):
        r = c.read_after(("PSUBSCRIBE" if pattern else "SUBSCRIBE"), ch)
        assert r[0] == (b"psubscribe" if pattern else b"subscribe")
        assert r[1] == ch.encode() and r[2] == i + 1
    c.sock.settimeout(5)
    return c


# RespClient.cmd reads exactly one reply; subscribe pushes come one per
# channel, so give the helper an alias that reads the single frame
def _read_after(self, *argv):
    return self.cmd(*argv)


RespClient.read_after = _read_after


def test_subscribe_publish_roundtrip(server, client):
    sub = sub_client(server, "news")
    assert client.cmd("PUBLISH", "news", "hello") == 1
    msg = sub.read_reply()
    assert msg == [b"message", b"news", b"hello"]
    # a channel nobody subscribes to reaches zero receivers
    assert client.cmd("PUBLISH", "void", "x") == 0
    sub.close()


def test_psubscribe_pmessage_and_counts(server, client):
    sub = sub_client(server, "ev.*", pattern=True)
    assert client.cmd("PUBLISH", "ev.user", "payload") == 1
    assert sub.read_reply() == [b"pmessage", b"ev.*", b"ev.user", b"payload"]
    # direct + pattern both count
    sub2 = sub_client(server, "ev.user")
    assert client.cmd("PUBLISH", "ev.user", "two") == 2
    sub.close()
    sub2.close()


def test_unsubscribe_and_pubsub_introspection(server, client):
    sub = sub_client(server, "a", "b")
    chans = set(client.cmd("PUBSUB", "CHANNELS"))
    assert chans == {b"a", b"b"}
    assert client.cmd("PUBSUB", "NUMSUB", "a", "zz") == [b"a", 1, b"zz", 0]
    assert client.cmd("PUBSUB", "NUMPAT") == 0
    r = sub.read_after("UNSUBSCRIBE", "a")
    assert r == [b"unsubscribe", b"a", 1]
    assert client.cmd("PUBSUB", "CHANNELS") == [b"b"]
    # unsubscribe-all drains the rest
    r = sub.read_after("UNSUBSCRIBE")
    assert r == [b"unsubscribe", b"b", 0]
    assert client.cmd("PUBSUB", "CHANNELS") == []
    sub.close()


def test_resp2_subscriber_mode_restricts_commands(server):
    sub = sub_client(server, "c")
    with pytest.raises(ReplyError, match="only .P.S.SUBSCRIBE"):
        sub.cmd("HSET", "k", "f", "v")
    assert sub.cmd("PING") in ("PONG", [b"pong", b""])
    sub.close()


def test_resp3_subscriber_multiplexes(server, client):
    sub = sub_client(server, "c3", proto=3)
    # RESP3 connections may run normal commands while subscribed
    assert sub.cmd("HSET", "k3", "f", "v") == 1
    assert client.cmd("PUBLISH", "c3", "m") == 1
    assert sub.read_reply() == [b"message", b"c3", b"m"]
    sub.close()


def test_keyspace_notifications_hset_del_expire(server, client):
    client.cmd("CONFIG", "SET", "search.notify-keyspace-events", "KEA")
    sub = sub_client(server, "__keyspace@0__:doc:1")
    ev = sub_client(server, "__keyevent@0__:*", pattern=True)
    client.cmd("HSET", "doc:1", "f", "v")
    assert sub.read_reply() == [b"message", b"__keyspace@0__:doc:1", b"hset"]
    assert ev.read_reply() == [
        b"pmessage", b"__keyevent@0__:*", b"__keyevent@0__:hset", b"doc:1"]
    client.cmd("EXPIRE", "doc:1", "100")
    assert sub.read_reply()[2] == b"expire"
    assert ev.read_reply()[2:] == [b"__keyevent@0__:expire", b"doc:1"]
    client.cmd("DEL", "doc:1")
    assert sub.read_reply()[2] == b"del"
    sub.close()
    ev.close()


def test_keyspace_notification_expired_event(server, client):
    client.cmd("CONFIG", "SET", "search.notify-keyspace-events", "KEA")
    ev = sub_client(server, "__keyevent@0__:expired")
    client.cmd("HSET", "gone", "f", "v")
    client.cmd("PEXPIRE", "gone", "30")
    time.sleep(0.08)
    client.cmd("HGETALL", "gone")  # lazy expiry path fires the event
    assert ev.read_reply() == [
        b"message", b"__keyevent@0__:expired", b"gone"]
    ev.close()


def test_notifications_off_by_default(server, client):
    sub = sub_client(server, "__keyspace@0__:quiet")
    client.cmd("HSET", "quiet", "f", "v")
    assert client.cmd("PUBLISH", "__keyspace@0__:quiet", "probe") == 1
    # the only frame is the explicit probe: no hset event leaked
    assert sub.read_reply() == [
        b"message", b"__keyspace@0__:quiet", b"probe"]
    sub.close()


def test_notification_class_filtering(server, client):
    # K + h only: hash events publish, generic (del/expire) do not
    client.cmd("CONFIG", "SET", "search.notify-keyspace-events", "Kh")
    sub = sub_client(server, "__keyspace@0__:kf")
    client.cmd("HSET", "kf", "f", "v")
    assert sub.read_reply()[2] == b"hset"
    client.cmd("EXPIRE", "kf", "100")   # class g: filtered out
    client.cmd("HSET", "kf", "g", "w")  # class h: arrives next
    assert sub.read_reply()[2] == b"hset"
    sub.close()


def test_subscribe_rejected_in_multi(server, client):
    client.cmd("MULTI")
    with pytest.raises(ReplyError, match="not allowed in transactions"):
        client.cmd("SUBSCRIBE", "x")
    with pytest.raises(ReplyError, match="EXECABORT"):
        client.cmd("EXEC")
