"""Lua 5.1 interpreter unit tests (server/lua.py).

The reference rides valkey-server's embedded Lua VM; these tests pin the
semantics our own interpreter must share with it: value model and
coercions, control flow, closures, multiple returns, the string library
(including the Lua pattern engine), table/math/bit/cjson libs, the
redis.call conversion rules, sandboxing, and the step budget that
replaces valkey's busy-script watchdog."""

import pytest

from valkey_search_tpu.server import lua as L


def run(src, call=None, keys=None, argv=None):
    rt = L.LuaRuntime(call or (lambda a: None), keys=keys, argv=argv)
    rets = rt.run(L.compile_script(src))
    return rets[0] if rets else None


def resp(src, **kw):
    return L.lua_to_resp(run(src, **kw),
                         status_factory=lambda s: ("STATUS", s))


# -- values & coercions --------------------------------------------------------

def test_number_model():
    assert resp("return 3.7") == 3          # return truncates to int
    assert run("return 2^10") == 1024.0
    assert run("return 7 % 3") == 1.0
    assert run("return -7 % 3") == 2.0      # Lua floor-mod, not C fmod
    assert run("return 10 / 4") == 2.5
    assert resp("return tostring(1.5)") == b"1.5"
    assert resp("return tostring(10)") == b"10"  # no trailing .0
    assert resp("return '2' + 3") == 5      # numeric-string coercion
    assert resp("return 'a' .. 1 .. 'b'") == b"a1b"


def test_tonumber():
    assert run("return tonumber('0x1F')") == 31.0
    assert run("return tonumber(' 42 ')") == 42.0
    assert run("return tonumber('z')") is None
    assert run("return tonumber('11', 2)") == 3.0
    assert run("return tonumber(true)") is None


def test_equality_and_compare():
    assert run("return 1 == 1.0") is True
    assert run("return '1' == 1") is False   # no coercion for ==
    assert run("return {} == {}") is False   # identity
    assert run("return 'abc' < 'abd'") is True
    with pytest.raises(L.LuaError, match="compare"):
        run("return 1 < 'x'")


def test_length_operator():
    assert run("return #'hello'") == 5.0
    assert run("return #{10, 20, 30}") == 3.0


# -- control flow ---------------------------------------------------------------

def test_loops_and_branches():
    assert run("local x=0 while x < 5 do x = x + 1 end return x") == 5.0
    assert run("local x=0 repeat x=x+1 until x>=4 return x") == 4.0
    assert resp("local s='' for i=5,1,-1 do s=s..i end return s") \
        == b"54321"
    assert resp("for i=1,10 do if i==3 then return i end end") == 3
    assert resp(
        "local n=0 for i=1,10 do if i>4 then break end n=i end return n"
    ) == 4
    assert resp(
        "if 1 > 2 then return 'a' elseif 2 > 3 then return 'b' "
        "else return 'c' end") == b"c"


def test_functions_closures_recursion():
    assert resp("local function f(a,b) return a+b end return f(2,3)") == 5
    assert resp(
        "local function mk() local c=0 return function() c=c+1 return c "
        "end end local g=mk() g() g() return g()") == 3
    assert resp(
        "local function fib(n) if n<2 then return n end "
        "return fib(n-1)+fib(n-2) end return fib(10)") == 55
    # method definition + colon call
    assert resp(
        "local o = {v=7} function o:get(m) return self.v * m end "
        "return o:get(6)") == 42


def test_multiple_returns():
    assert resp(
        "local function mr() return 1,2,3 end local a,b,c = mr() "
        "return a+b+c") == 6
    assert resp("local a,b = 1 return tostring(b)") == b"nil"
    # last call in a constructor expands; parenthesized truncates
    assert resp(
        "local t = {(function() return 1,2,3 end)()} return #t") == 3
    assert resp(
        "local t = {((function() return 1,2,3 end)())} return #t") == 1


# -- tables ----------------------------------------------------------------------

def test_table_ops():
    assert resp("local t={10,20,30,x=99} return t[2]+t.x") == 119
    assert resp("local t={} t['k']='v' return t.k") == b"v"
    assert resp("local t={1,2,3} table.insert(t, 4) return #t") == 4
    assert resp(
        "local t={1,2,3} table.insert(t, 1, 0) return t[1]..t[4]") == b"03"
    assert resp("local t={5,3,1} table.sort(t) return t[1]") == 1
    assert resp(
        "local t={5,3,1} table.sort(t, function(a,b) return a>b end) "
        "return t[1]") == 5
    assert resp("local t={'a','b'} return table.concat(t, '-')") == b"a-b"
    assert resp("local t={1,2,3} return table.remove(t) + #t") == 5
    assert resp(
        "local s=0 for k,v in pairs({a=1,b=2,c=3}) do s=s+v end "
        "return s") == 6
    assert resp(
        "local s=0 for i,v in ipairs({2,4,6}) do s=s+i*v end return s") \
        == 28
    assert resp("return select('#', 1, 2, 3)") == 3
    assert resp("return unpack({7})") == 7
    with pytest.raises(L.LuaError, match="index is nil"):
        run("local t={} t[nil]=1")


# -- string library ---------------------------------------------------------------

def test_string_basics():
    assert resp("return string.sub('hello', 2, 4)") == b"ell"
    assert resp("return string.sub('hello', -3)") == b"llo"
    assert resp("return ('abc'):upper()") == b"ABC"
    assert resp("return string.rep('ab', 3)") == b"ababab"
    assert resp("return string.reverse('abc')") == b"cba"
    assert resp("return string.byte('A')") == 65
    assert resp("return string.char(72, 105)") == b"Hi"
    assert resp("return ('%d'):format(42)") == b"42"


def test_string_format():
    assert resp(
        "return string.format('%d/%s/%05.1f', 3, 'x', 2.5)") == b"3/x/002.5"
    assert resp("return string.format('%x', 255)") == b"ff"
    assert resp("return string.format('%-4d|', 7)") == b"7   |"
    assert resp("return string.format('%q', 'a\"b')") == b'"a\\"b"'
    assert resp("return string.format('%s', {ok=1}):sub(1,5)") == b"table"


def test_lua_patterns():
    assert resp("return string.find('hello world', 'wor')") == 7
    assert resp("return string.find('a.b', '.', 1, true)") == 2
    assert resp("return string.match('key=val', '(%w+)=(%w+)')") == b"key"
    assert resp(
        "local a,b = string.match('key=val', '(%w+)=(%w+)') return b") \
        == b"val"
    assert resp(
        "local n=0 for w in string.gmatch('one two three', '%a+') "
        "do n=n+1 end return n") == 3
    assert resp(
        "return (string.gsub('abc abc', 'a(b)c', '%1!'))") == b"b! b!"
    assert resp("return string.gsub('hello', 'l+', 'L')") == b"heLo"
    assert resp(
        "return string.match('2024-01-15', '(%d+)-(%d+)-(%d+)')") == b"2024"
    assert resp("return string.match('  x  ', '^%s*(.-)%s*$')") == b"x"
    assert resp("return string.find('[tag]', '%b[]')") == 1
    assert resp(
        "return string.gsub('abc', '%w', function(c) return c:upper() "
        "end)") == b"ABC"
    assert resp("return ({string.gsub('aaa', 'a', 'b')})[2]") == 3
    assert run("return string.find('xyz', 'a')") is None


# -- math / bit -------------------------------------------------------------------

def test_math_lib():
    assert resp("return math.floor(3.9) + math.ceil(0.1)") == 4
    assert resp("return math.max(1, 9, 4)") == 9
    assert resp("return math.min(3, -2)") == -2
    assert run("return math.huge > 1e300") is True
    assert resp("return math.abs(-5)") == 5
    # deterministic seeded PRNG inside the documented range
    assert run("return math.random(5) >= 1 and math.random(5) <= 5") \
        is True
    v1 = run("math.randomseed(42) return math.random(1000)")
    v2 = run("math.randomseed(42) return math.random(1000)")
    assert v1 == v2


def test_bit_lib():
    assert resp("return bit.band(0xFF, 0x0F)") == 15
    assert resp("return bit.bor(1, 2, 4)") == 7
    assert resp("return bit.bxor(5, 3)") == 6
    assert resp("return bit.lshift(1, 4)") == 16
    assert resp("return bit.rshift(256, 4)") == 16
    assert resp("return bit.bnot(0)") == -1
    assert resp("return bit.tohex(255)") == b"000000ff"


# -- cjson ------------------------------------------------------------------------

def test_cjson_roundtrip():
    assert resp("return cjson.decode('{\"a\": [1,2]}').a[2]") == 2
    assert resp("return cjson.encode({1,2,{a=3}})") == b'[1,2,{"a":3}]'
    assert resp("return cjson.encode(cjson.decode('[true, null, 1.5]'))") \
        == b"[true,null,1.5]"
    assert run("return cjson.decode('null') == cjson.null") is True
    assert resp("return cjson.encode({})") == b"{}"
    assert resp("return type(cjson.null)") == b"userdata"
    with pytest.raises(L.LuaError, match="decode failed"):
        run("return cjson.decode('{bad')")


# -- errors, pcall, sandbox, budget ------------------------------------------------

def test_error_and_pcall():
    assert resp(
        "local ok, err = pcall(function() error('boom') end) "
        "return tostring(ok)..':'..tostring(err)") == b"false:boom"
    assert resp("return assert(42)") == 42
    with pytest.raises(L.LuaError, match="assertion failed"):
        run("assert(false)")
    with pytest.raises(L.LuaError, match="boom"):
        run("error('boom')")


def test_sandbox_no_os_io_load():
    for g in ("os", "io", "debug", "loadstring", "load", "dofile",
              "require", "collectgarbage", "getfenv", "setfenv"):
        assert run(f"return type({g})") == b"nil"
    with pytest.raises(L.LuaError, match="attempt to (index|call) a nil"):
        run("os.execute('rm -rf /')")


def test_step_budget_stops_infinite_loops():
    with pytest.raises(L.LuaError, match="instruction budget"):
        run("while true do end")
    with pytest.raises(L.LuaError, match="stack overflow"):
        run("local function f() return f() end f()")
    # a catchable script error, not a Python RecursionError: pcall sees it
    assert resp(
        "local function f() return f() end "
        "local ok, e = pcall(f) "
        "if not ok and string.find(e, 'overflow', 1, true) then "
        "return 'caught' end return 'missed'") == b"caught"


def test_runtime_type_errors():
    with pytest.raises(L.LuaError, match="arithmetic"):
        run("return {} + 1")
    with pytest.raises(L.LuaError, match="concatenate"):
        run("return 'a' .. nil")
    with pytest.raises(L.LuaError, match="call a nil value"):
        run("nosuchfn()")
    with pytest.raises(L.LuaError, match="index a nil value"):
        run("return nosuchtable.field")


def test_parse_errors():
    for src in ("return 1 +", "if x then", "local = 3", "return 'abc",
                "for i=1 do end", "fn(,)"):
        with pytest.raises(L.LuaError, match="parse error"):
            L.compile_script(src)


# -- redis API + conversion rules ---------------------------------------------------

def host(argv):
    c = argv[0].decode().upper()
    if c == "PING":
        return b"PONG"
    if c == "ECHON":
        return len(argv) - 1
    if c == "FAILME":
        raise L.RedisCallError("WRONGTYPE bad op")
    if c == "LIST":
        return [b"one", b"two", None, 3]
    return None


def test_redis_call_conversion():
    assert resp("return redis.call('PING')", call=host) == b"PONG"
    # integer reply -> number; nil reply -> false -> RESP nil
    assert resp("return redis.call('ECHON', 'a', 'b')", call=host) == 2
    assert resp("return redis.call('NOPE')", call=host) is None
    # array reply with a nil hole -> table; RESP nil -> Lua false
    assert resp(
        "local t = redis.call('LIST') "
        "return tostring(t[3])..':'..tostring(t[4])",
        call=host) == b"false:3"
    # numbers auto-stringify as command args; booleans refused
    assert resp("return redis.call('ECHON', 1, 2.5)", call=host) == 2
    with pytest.raises(L.LuaError, match="strings or integers"):
        run("redis.call('PING', true)", call=host)


def test_redis_call_vs_pcall_errors():
    # call: aborts the script with the command error
    with pytest.raises(L.LuaError) as ei:
        run("redis.call('FAILME')", call=host)
    assert b"WRONGTYPE bad op" in ei.value.value.data[b"err"]
    # pcall: returns the error table, script continues
    assert resp(
        "local t = redis.pcall('FAILME') return t.err", call=host) \
        == b"WRONGTYPE bad op"


def test_status_and_error_reply():
    assert resp("return redis.status_reply('GOOD')") == ("STATUS", "GOOD")
    t = run("return redis.error_reply('myerr')")
    assert t.data[b"err"] == b"myerr"
    assert resp("return redis.sha1hex('')") \
        == b"da39a3ee5e6b4b0d3255bfef95601890afd80709"
    assert run("return redis.replicate_commands()") is True
    assert run("redis.log(redis.LOG_WARNING, 'x')") is None


def test_keys_argv():
    assert resp("return KEYS[1] .. ARGV[2]",
                keys=[b"k1"], argv=[b"a1", b"a2"]) == b"k1a2"
    assert resp("return #KEYS + #ARGV",
                keys=[b"k1"], argv=[b"a1", b"a2"]) == 3


def test_lua_to_resp_rules():
    assert resp("return true") == 1
    assert resp("return false") is None
    assert resp("return nil") is None
    assert resp("return {1,'two',nil,4}") == [1, b"two"]  # stops at nil
    assert resp("return {ok='FINE'}") == ("STATUS", "FINE")
    assert resp("return 3.99") == 3


def test_binary_safe_strings():
    # NUL bytes survive the full path (Lua strings are byte strings)
    assert resp(r"return 'a\0b' .. string.char(255)") == b"a\x00b\xff"
    assert resp(r"return #'a\0b'") == 3


def test_long_strings_and_comments():
    assert resp("--[[ block\ncomment ]] return [[raw\nstring]]") \
        == b"raw\nstring"
    assert resp("return [==[a]b]==]") == b"a]b"


def test_nonfinite_return_saturates():
    # (long long) cast semantics: inf/NaN/overflow must not raise
    # (`return 1/0` produced '-ERR internal error')
    assert resp("return 1/0") == 2**63 - 1
    assert resp("return -1/0") == -(2**63)
    assert resp("return 0/0") == 0
    assert resp("return 2^1024") == 2**63 - 1
    assert resp("return -(2^1024)") == -(2**63)


def test_parser_depth_limit():
    # deep nesting raises a LuaError, not Python RecursionError
    deep = "return " + "(" * 400 + "1" + ")" * 400
    with pytest.raises(L.LuaError, match="too many syntax levels"):
        L.compile_script(deep)
    # at a legal depth it still parses and runs
    ok = "return " + "(" * 50 + "1" + ")" * 50
    assert resp(ok) == 1
