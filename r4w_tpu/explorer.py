"""Interactive waveform explorer — a web dashboard.

Stands in for the reference's 45k-LoC egui/WASM `WaveformExplorer`
(crates/r4w-gui/src/app.rs:231) at its interactive core, now covering
the three biggest reference views:

- **Waveform demo** (views/generic_pipeline.rs role): pick a waveform,
  payload, and any of the NINE channel models (channel.rs:47-66 suite:
  ideal/awgn/awgn_cfo/multipath/rayleigh/rician/tdl_awgn/jakes +
  per-model knobs), see constellation/time/spectrum/waterfall plots
  and the staged TX introspection.
- **Pipeline wizard** (views/pipeline_wizard.rs:1-11049 role): assemble
  a block graph from the 523-block registry (plus waveform_tx/rx
  pseudo-blocks), run it server-side via r4w_tpu.pipeline, and see
  per-node time/constellation/PSD previews — the per-block-simulate
  workflow in the browser.
- **GNSS sky view** (views/gnss_simulator.rs:364 role): polar sky plot
  + C/N0 bars from a GnssScenario (preset or pasted scenario YAML),
  with elapsed-time scrubbing driving Doppler/elevation evolution.

Pure stdlib HTTP + JSON; demo plots are matplotlib PNGs, pipeline and
sky views render client-side on <canvas> from JSON data.

Endpoints:
  GET  /                  — the single-page UI
  GET  /api/waveforms     — JSON list of factory names
  GET  /api/blocks?q=     — registry catalog (name/category/params)
  GET  /api/demo?name=..&snr=..&hex=..&channel=..&cfo_hz=..&
                 doppler_hz=..&tdl_profile=..&rician_k=..
  POST /api/pipeline      — body {nodes:[{id,block,params,inputs}]}
  GET  /api/gnss_sky?preset=e1c_8prn&t=0   (or POST with YAML body)
  POST /api/remote        — body {agent_host,agent_port,command,...}
                            relay to a r4w-tpu agent; target:"stream"
                            points its TX at the live waterfall
  POST /api/stream/start  — body {port?,fs?,fft?} → loopback UDP port
  POST /api/stream/tx     — body {name?,hex?,snr?,reps?} test burst
  GET  /api/stream/rows?since=N — incremental waterfall rows + stats
  POST /api/stream/stop

Run: `r4w-tpu explore --port 8080` or
     `python -m r4w_tpu.explorer --port 8080`.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

CHANNEL_MODELS = ("none", "awgn", "awgn_cfo", "multipath", "rayleigh",
                  "rician", "tdl_awgn", "jakes")

_PAGE = """<!DOCTYPE html>
<html><head><title>r4w-tpu explorer</title><style>
body{font-family:system-ui,sans-serif;margin:0;background:#11151c;color:#e6e6e6}
header{padding:12px 20px;background:#1a2230;font-size:18px;display:flex;gap:24px}
header .tab{cursor:pointer;color:#9fb3c8}
header .tab.active{color:#fff;border-bottom:2px solid #2f6feb}
main{display:flex;gap:16px;padding:16px}
#controls,#pctrl,#gctrl,#lctrl{min-width:280px;max-width:320px;background:#1a2230;
padding:16px;border-radius:8px;align-self:flex-start}
label{display:block;margin:10px 0 4px;font-size:13px;color:#9fb3c8}
select,input,textarea{width:100%;padding:6px;background:#0d1117;color:#e6e6e6;
border:1px solid #30363d;border-radius:4px;box-sizing:border-box}
button{margin-top:10px;width:100%;padding:8px;background:#2f6feb;
color:white;border:none;border-radius:6px;cursor:pointer}
button.small{width:auto;padding:4px 10px;margin:4px 4px 0 0;background:#30363d}
#plots{flex:1;display:grid;grid-template-columns:1fr 1fr;gap:12px}
#plots img{width:100%;background:#fff;border-radius:6px}
#metrics{grid-column:1/3;background:#1a2230;padding:12px;
border-radius:8px;font-family:monospace;white-space:pre-wrap;font-size:12px}
.node{background:#1a2230;border-radius:8px;padding:10px;margin-bottom:10px}
.node h4{margin:0 0 6px;font-size:14px}
.node .err{color:#ff7b72;font-family:monospace;font-size:12px}
.node canvas{background:#0d1117;border-radius:4px;margin-right:6px}
.nrow{display:flex;gap:8px;align-items:center;margin-bottom:6px}
.nrow select,.nrow input{flex:1}
#pnodes{flex:1}
#sky{flex:1;display:flex;gap:16px;flex-wrap:wrap}
canvas.big{background:#0d1117;border-radius:8px}
.meta{font-family:monospace;font-size:12px;color:#9fb3c8;white-space:pre}
</style></head><body>
<header>r4w-tpu explorer
 <span class=tab data-v=demo>waveform demo</span>
 <span class=tab data-v=pipe>pipeline wizard</span>
 <span class=tab data-v=gnss>gnss sky</span>
 <span class=tab data-v=live>live stream</span>
</header>

<main id=v_demo>
 <div id=controls>
  <label>Waveform</label><select id=wf></select>
  <label>Payload (hex)</label><input id=hex value=A71B3CD2>
  <label>Channel</label><select id=chan></select>
  <label>SNR (dB)</label><input id=snr type=number value=15>
  <label>CFO (Hz) — awgn_cfo</label><input id=cfo_hz type=number value=200>
  <label>Doppler (Hz) — tdl/jakes</label>
  <input id=doppler_hz type=number value=50>
  <label>TDL profile</label>
  <select id=tdl_profile><option>EPA</option><option>EVA</option>
  <option>ETU</option></select>
  <label>Rician K</label><input id=rician_k type=number value=5>
  <button onclick=runDemo()>Run</button>
 </div>
 <div id=plots>
  <img id=time><img id=spectrum><img id=constellation><img id=waterfall>
  <div id=metrics>pick a waveform and press Run</div>
 </div>
</main>

<main id=v_pipe style="display:none">
 <div id=pctrl>
  <label>Add block</label><select id=blocksel></select>
  <button class=small onclick=addNode()>+ add</button>
  <button class=small onclick="preset()">demo preset</button>
  <div class=meta id=blockinfo></div>
  <button onclick=runPipe()>Run pipeline</button>
  <div class=meta>nodes chain top→bottom; edit params inline.
  waveform_tx / waveform_rx bracket a registry chain.</div>
 </div>
 <div id=pnodes></div>
</main>

<main id=v_gnss style="display:none">
 <div id=gctrl>
  <label>Preset</label>
  <select id=gpreset><option>e1c_8prn</option><option>gps_l1ca_6sv</option>
  </select>
  <label>Elapsed time (s)</label><input id=gt type=range min=0 max=60
   value=0 oninput="gtv.textContent=this.value">
  <span class=meta>t = <span id=gtv>0</span> s</span>
  <label>…or paste scenario YAML</label>
  <textarea id=gyaml rows=8 placeholder="satellites: ..."></textarea>
  <button onclick=runSky()>Update sky</button>
 </div>
 <div id=sky>
  <canvas id=skyplot class=big width=420 height=420></canvas>
  <canvas id=cn0bars class=big width=420 height=420></canvas>
  <div class=meta id=gmeta></div>
 </div>
</main>

<main id=v_live style="display:none">
 <div id=lctrl>
  <label>Sample rate (Hz)</label><input id=lfs type=number value=250000>
  <label>FFT size</label>
  <select id=lfft><option>128</option><option selected>256</option>
  <option>512</option></select>
  <button class=small onclick=liveStart()>start</button>
  <button class=small onclick=liveStop()>stop</button>
  <div class=meta id=lstat>stopped — start opens a loopback UDP port
for [seq u32][f32 I/Q] packets (net.py / `r4w-tpu udp-send` format)</div>
  <label>Test burst waveform</label><select id=lwf></select>
  <label>Payload (hex)</label><input id=lhex value=A71B3CD2>
  <label>SNR (dB, empty = clean)</label><input id=lsnr value=20>
  <button class=small onclick=liveTx()>send test burst</button>
  <label style="margin-top:18px">— remote lab (r4w-tpu agent) —</label>
  <label>Agent host:port</label>
  <div class=nrow><input id=rahost value=127.0.0.1>
   <input id=raport value=6000 style="max-width:70px"></div>
  <button class=small onclick="remoteCmd('ping')">ping</button>
  <button class=small onclick="remoteCmd('status')">status</button>
  <button class=small onclick=remoteTx()>agent TX &rarr; waterfall</button>
  <button class=small onclick="remoteCmd('stop_tx')">stop TX</button>
  <div class=meta id=rstat></div>
 </div>
 <div><canvas id=wfcanvas class=big width=512 height=360></canvas>
  <div class=meta id=lmeta></div></div>
</main>

<script>
const $=id=>document.getElementById(id);
document.querySelectorAll('.tab').forEach(t=>t.onclick=()=>{
 document.querySelectorAll('.tab').forEach(x=>x.classList.remove('active'));
 t.classList.add('active');
 for(const v of ['demo','pipe','gnss','live'])
  $('v_'+v).style.display=(t.dataset.v==v)?'flex':'none';
});
document.querySelector('.tab').classList.add('active');

let liveNext=0, liveTimer=null;
async function liveStart(){
 const r=await (await fetch('/api/stream/start',{method:'POST',
  body:JSON.stringify({fs:+$('lfs').value,fft:+$('lfft').value})})).json();
 if(r.error){$('lstat').textContent=r.error;return;}
 $('lstat').textContent=`listening on udp://127.0.0.1:${r.port}`;
 liveNext=0;
 const c=$('wfcanvas').getContext('2d');
 c.fillStyle='#0d1117';c.fillRect(0,0,512,360);
 if(liveTimer)clearInterval(liveTimer);
 liveTimer=setInterval(livePoll,250);
}
async function liveStop(){
 if(liveTimer){clearInterval(liveTimer);liveTimer=null;}
 await fetch('/api/stream/stop',{method:'POST',body:'{}'});
 $('lstat').textContent='stopped';
}
async function liveTx(){
 const r=await (await fetch('/api/stream/tx',{method:'POST',
  body:JSON.stringify({name:$('lwf').value,hex:$('lhex').value,
   snr:$('lsnr').value})})).json();
 $('lmeta').textContent=JSON.stringify(r);
}
async function remoteCmd(cmd,extra){
 const body={agent_host:$('rahost').value,agent_port:+$('raport').value,
  command:cmd,...(extra||{})};
 const r=await (await fetch('/api/remote',{method:'POST',
  body:JSON.stringify(body)})).json();
 $('rstat').textContent=JSON.stringify(r);
 return r;
}
async function remoteTx(){
 await remoteCmd('start_tx',{target:'stream',waveform:$('lwf').value,
  message:'remote lab tx',repeat:true,pps:4});
}
function heat(v){ // 0..1 -> color
 const r=Math.min(255,Math.floor(v*512)),
       g=Math.max(0,Math.floor(v*255-64)),
       b=Math.floor(96+96*Math.sin(v*3.14));
 return `rgb(${r},${g},${b})`;
}
async function livePoll(){
 const r=await (await fetch('/api/stream/rows?since='+liveNext)).json();
 if(r.error)return;
 liveNext=r.next;
 const s=r.stats;
 $('lmeta').textContent=
  `rows ${r.next}  packets ${s.packets}  dropped ${s.dropped}  `+
  `samples ${s.samples}`;
 if(!r.rows.length)return;
 const cv=$('wfcanvas'),c=cv.getContext('2d');
 for(const row of r.rows){
  c.drawImage(cv,0,0,512,359,0,1,512,359);      // scroll down 1px
  const lo=Math.min(...row),hi=Math.max(...row),rng=Math.max(hi-lo,1e-9);
  const w=512/row.length;
  for(let i=0;i<row.length;i++){
   c.fillStyle=heat((row[i]-lo)/rng);
   c.fillRect(i*w,0,Math.ceil(w),1);
  }
 }
}

let BLOCKS=[];
async function init(){
 const names=await (await fetch('/api/waveforms')).json();
 for(const n of names){const o=document.createElement('option');
  o.textContent=n;$('wf').appendChild(o);
  const o2=document.createElement('option');
  o2.textContent=n;if(n=='QPSK')o2.selected=true;
  $('lwf').appendChild(o2);}
 for(const c of %CHANNELS%){const o=document.createElement('option');
  o.textContent=c;$('chan').appendChild(o);}
 BLOCKS=await (await fetch('/api/blocks')).json();
 BLOCKS.unshift({name:'waveform_tx',category:'source',params:['name','hex']},
                {name:'waveform_rx',category:'sink',params:['name','hex']});
 for(const b of BLOCKS){const o=document.createElement('option');
  o.textContent=b.name;$('blocksel').appendChild(o);}
 $('blocksel').onchange=()=>{
  const b=BLOCKS.find(x=>x.name==$('blocksel').value);
  $('blockinfo').textContent=b?(b.category+': '+(b.description||'')+
   '\\nparams: '+b.params.join(', ')):'';
 };
}
async function runDemo(){
 const q=new URLSearchParams({name:wf.value,hex:hex.value,
  channel:chan.value,snr:snr.value,cfo_hz:cfo_hz.value,
  doppler_hz:doppler_hz.value,tdl_profile:tdl_profile.value,
  rician_k:rician_k.value});
 $('metrics').textContent='running…';
 const r=await (await fetch('/api/demo?'+q)).json();
 if(r.error){$('metrics').textContent=r.error;return;}
 for(const k of ['time','spectrum','constellation','waterfall'])
  if(r.plots[k]) $(k).src='data:image/png;base64,'+r.plots[k];
 $('metrics').textContent=JSON.stringify(r.metrics,null,1)
  +'\\n\\nstages: '+r.stages.join(' → ');
}

// ---------------- pipeline wizard ----------------
let NODES=[];const SCHEMAS={};
async function fetchSchema(name){
 if(SCHEMAS[name]!==undefined) return SCHEMAS[name];
 try{
  const rows=await (await fetch('/api/blocks?schema=1&q='+
   encodeURIComponent(name))).json();
  const row=rows.find(r=>r.name==name);
  SCHEMAS[name]=(row&&row.schema)||[];
 }catch(e){SCHEMAS[name]=[];}
 return SCHEMAS[name];
}
async function addNode(name){
 name=name||$('blocksel').value;
 const b=BLOCKS.find(x=>x.name==name)||{params:[]};
 const schema=await fetchSchema(name);
 // typed form fields: config params (role=param) with defaults
 // pre-filled; stream inputs wire from the upstream node
 const cfg=schema.filter(s=>s.role=='param');
 const params=cfg.length?
  Object.fromEntries(cfg.map(s=>[s.name,
   s.default===null||s.default===undefined?'':String(s.default)])):
  Object.fromEntries(b.params.map(p=>[p,'']));
 NODES.push({id:'n'+NODES.length,block:name,params,
  schema:Object.fromEntries(schema.map(s=>[s.name,s])),out:null});
 renderNodes();
}
async function preset(){
 NODES=[];
 await addNode('waveform_tx');NODES[0].params={name:'QPSK',hex:'CAFE1234'};
 await addNode('awgn_channel');NODES[1].params={snr_db:'14'};
 await addNode('dc_blocker');
 await addNode('waveform_rx');NODES[3].params={name:'QPSK',hex:'CAFE1234'};
 renderNodes();
}
function renderNodes(){
 const host=$('pnodes');host.innerHTML='';
 NODES.forEach((n,i)=>{
  const d=document.createElement('div');d.className='node';
  let h='<h4>'+n.id+' · '+n.block+
   ' <button class=small onclick=delNode('+i+')>✕</button></h4>';
  for(const k of Object.keys(n.params)){
   const s=(n.schema&&n.schema[k])||{};
   const typ=s.type?(' <span class=meta>('+s.type+
    (s.required?', required':'')+')</span>'):'';
   const tip=(s.doc||'').replace(/"/g,'&quot;');
   h+='<div class=nrow><span class=meta title="'+tip+'">'+k+typ+
    '</span><input value="'+(n.params[k]??'')+'" title="'+tip+'" '+
    'onchange="NODES['+i+'].params[\\''+k+'\\']=this.value"></div>';
  }
  d.innerHTML=h;
  if(n.out){
   if(n.out.error) d.innerHTML+='<div class=err>'+n.out.error+'</div>';
   else{
    d.innerHTML+='<div class=meta>shape '+JSON.stringify(n.out.shape)+
     ' '+n.out.dtype+(n.out.power_db!==undefined?(' · '+n.out.power_db+
     ' dB'):'')+(n.out.decoded_ok!==undefined?(' · decoded_ok='+
     n.out.decoded_ok):'')+'</div>';
    const cv1=document.createElement('canvas');cv1.width=220;cv1.height=120;
    const cv2=document.createElement('canvas');cv2.width=220;cv2.height=120;
    const cv3=document.createElement('canvas');cv3.width=220;cv3.height=120;
    d.append(cv1,cv2,cv3);
    drawLine(cv1,n.out.preview.time_re,n.out.preview.time_im,'time');
    drawPsd(cv2,n.out.preview.psd_db);
    if(n.out.preview.const_re)
     drawConst(cv3,n.out.preview.const_re,n.out.preview.const_im);
   }
  }
  host.appendChild(d);
 });
}
function delNode(i){NODES.splice(i,1);renderNodes();}
async function runPipe(){
 const nodes=NODES.map((n,i)=>({id:n.id,block:n.block,
  params:Object.fromEntries(Object.entries(n.params)
   .filter(([k,v])=>v!=='')),
  inputs:i?[NODES[i-1].id]:[]}));
 const r=await (await fetch('/api/pipeline',{method:'POST',
  body:JSON.stringify({nodes})})).json();
 if(r.error){alert(r.error);return;}
 NODES.forEach(n=>n.out=r.nodes[n.id]);
 renderNodes();
}
function drawLine(cv,re,im,title){
 const c=cv.getContext('2d');c.clearRect(0,0,cv.width,cv.height);
 const all=im?re.concat(im):re;
 const lo=Math.min(...all),hi=Math.max(...all),sp=(hi-lo)||1;
 const plot=(v,col)=>{c.strokeStyle=col;c.beginPath();
  v.forEach((y,i)=>{const px=i/(v.length-1||1)*cv.width,
   py=cv.height-8-(y-lo)/sp*(cv.height-16);
   i?c.lineTo(px,py):c.moveTo(px,py);});c.stroke();};
 plot(re,'#58a6ff');if(im)plot(im,'#f78166');
 c.fillStyle='#9fb3c8';c.fillText(title,4,10);
}
function drawPsd(cv,psd){
 const c=cv.getContext('2d');c.clearRect(0,0,cv.width,cv.height);
 const lo=Math.min(...psd),hi=Math.max(...psd),sp=(hi-lo)||1;
 c.strokeStyle='#7ee787';c.beginPath();
 psd.forEach((y,i)=>{const px=i/(psd.length-1||1)*cv.width,
  py=cv.height-8-(y-lo)/sp*(cv.height-16);
  i?c.lineTo(px,py):c.moveTo(px,py);});c.stroke();
 c.fillStyle='#9fb3c8';c.fillText('psd (dB)',4,10);
}
function drawConst(cv,re,im){
 const c=cv.getContext('2d');c.clearRect(0,0,cv.width,cv.height);
 const m=Math.max(...re.map(Math.abs),...im.map(Math.abs))||1;
 c.fillStyle='#d2a8ff';
 re.forEach((x,i)=>{c.fillRect(cv.width/2+x/m*(cv.width/2-8)-1,
  cv.height/2-im[i]/m*(cv.height/2-8)-1,2,2);});
 c.fillStyle='#9fb3c8';c.fillText('constellation',4,10);
}

// ---------------- gnss sky ----------------
async function runSky(){
 const yaml=$('gyaml').value.trim();
 let r;
 if(yaml) r=await (await fetch('/api/gnss_sky?t='+$('gt').value,
  {method:'POST',body:yaml})).json();
 else r=await (await fetch('/api/gnss_sky?preset='+$('gpreset').value+
  '&t='+$('gt').value)).json();
 if(r.error){$('gmeta').textContent=r.error;return;}
 drawSky(r.sats);drawCn0(r.sats);
 $('gmeta').textContent=r.sats.map(s=>
  'PRN'+String(s.prn).padStart(2,'0')+' '+s.signal+
  '  el '+s.elevation_deg.toFixed(1)+'°  az '+s.azimuth_deg.toFixed(0)+
  '°  C/N0 '+s.cn0_dbhz.toFixed(1)+'  dop '+s.doppler_hz.toFixed(0)+' Hz'
 ).join('\\n');
}
function drawSky(sats){
 const cv=$('skyplot'),c=cv.getContext('2d');
 c.clearRect(0,0,cv.width,cv.height);
 const cx=cv.width/2,cy=cv.height/2,R=cv.width/2-20;
 c.strokeStyle='#30363d';
 for(const e of [0,30,60]){c.beginPath();
  c.arc(cx,cy,R*(90-e)/90,0,7);c.stroke();}
 c.fillStyle='#9fb3c8';c.fillText('N',cx-3,14);c.fillText('E',cv.width-12,cy);
 for(const s of sats){
  const r=R*(90-s.elevation_deg)/90,a=(s.azimuth_deg-90)*Math.PI/180;
  const x=cx+r*Math.cos(a),y=cy+r*Math.sin(a);
  c.fillStyle='#7ee787';c.beginPath();c.arc(x,y,6,0,7);c.fill();
  c.fillStyle='#e6e6e6';c.fillText('PRN'+s.prn,x+8,y+4);
 }
}
function drawCn0(sats){
 const cv=$('cn0bars'),c=cv.getContext('2d');
 c.clearRect(0,0,cv.width,cv.height);
 const w=cv.width/(sats.length||1);
 sats.forEach((s,i)=>{
  const h=Math.max(0,(s.cn0_dbhz-20)/35)*(cv.height-40);
  c.fillStyle='#58a6ff';c.fillRect(i*w+6,cv.height-20-h,w-12,h);
  c.fillStyle='#9fb3c8';c.fillText('PRN'+s.prn,i*w+4,cv.height-6);
  c.fillText(s.cn0_dbhz.toFixed(0),i*w+8,cv.height-26-h);
 });
 c.fillStyle='#9fb3c8';c.fillText('C/N0 (dB-Hz)',6,12);
}
init();
</script></body></html>"""


def _png_b64(plot_fn, *args, **kw) -> str:
    """Render a viz plot to an in-memory PNG, base64-encoded."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        plot_fn(*args, path=f.name, **kw)
        f.seek(0)
        return base64.b64encode(f.read()).decode()


def run_demo(name: str, hex_payload: str = "A71B3CD2",
             channel: str = "none", snr_db: float = 15.0,
             cfo_hz: float = 0.0, doppler_hz: float = 50.0,
             tdl_profile: str = "EPA", rician_k: float = 5.0) -> dict:
    """One explorer round: modulate → channel (full 9-model suite via
    apply_channel, channel.rs:618-646) → demodulate → plots."""
    import jax

    from r4w_tpu import viz
    from r4w_tpu.channel import ChannelConfig, apply_channel
    from r4w_tpu.waveforms import create_waveform

    wf = create_waveform(name)
    if wf is None:
        return {"error": f"unknown waveform {name!r}"}
    try:
        payload = bytes.fromhex(hex_payload) if hex_payload else b""
    except ValueError:
        return {"error": f"bad hex payload {hex_payload!r}"}

    tx = wf.modulate(payload)
    if channel in ("none", "ideal", ""):
        rx = tx
    else:
        cfg = ChannelConfig(
            model=channel, snr_db=float(snr_db),
            sample_rate=wf.common_params.sample_rate,
            cfo_hz=float(cfo_hz), doppler_hz=float(doppler_hz),
            tdl_profile=tdl_profile, rician_k=float(rician_k),
            multipath_delay=8, multipath_amplitude=0.4)
        rx = apply_channel(jax.random.key(0), tx, cfg)
    res = wf.demodulate(rx)

    got = np.asarray(res.bits)[: len(payload)]
    match = got.tolist() == list(payload) if len(payload) else None
    fs = wf.common_params.sample_rate
    rx_np = np.asarray(jax.device_get(rx))
    sps = max(wf.samples_per_symbol(), 1)
    sym = rx_np[: (len(rx_np) // sps) * sps].reshape(-1, sps).mean(axis=1)

    plots = {
        "time": _png_b64(viz.plot_time, rx_np[:2048],
                         title=f"{name} — time domain"),
        "spectrum": _png_b64(viz.plot_spectrum, rx_np, sample_rate=fs,
                             title=f"{name} — spectrum"),
        "constellation": _png_b64(viz.plot_constellation, sym[:2000],
                                  title=f"{name} — symbol space"),
        "waterfall": _png_b64(viz.plot_waterfall, rx_np, sample_rate=fs,
                              title=f"{name} — waterfall"),
    }
    stages = [s for s, _ in wf.get_modulation_stages(payload)] \
        if len(payload) else ["modulated IQ"]
    metrics = {
        "samples": int(len(rx_np)),
        "sample_rate": fs,
        "samples_per_symbol": sps,
        "channel": channel,
        "decoded_ok": match,
        "decoded_hex": bytes(got.astype(np.uint8)).hex() if len(got) else "",
        "snr_estimate_db": res.snr_estimate,
        **{k: v for k, v in res.metadata.items()
           if isinstance(v, (int, float, str, bool))},
    }
    return {"metrics": metrics, "plots": plots, "stages": stages}


def _sky_preset(name: str):
    """Built-in demo scenarios for the sky view."""
    from r4w_tpu.gnss.scenario import (ReceiverConfig, SatelliteConfig,
                                       ScenarioConfig)

    if name == "gps_l1ca_6sv":
        sats = tuple(
            SatelliteConfig(prn=p, signal="gpsl1ca", cn0_dbhz=cn0,
                            elevation_deg=el, azimuth_deg=az,
                            doppler_hz=dop)
            for p, cn0, el, az, dop in [
                (2, 47.0, 72.0, 30.0, -1200.0), (5, 44.0, 55.0, 120.0, 800.0),
                (12, 41.0, 38.0, 200.0, 2400.0), (18, 38.0, 25.0, 280.0,
                                                  -3100.0),
                (25, 35.0, 15.0, 340.0, 3500.0), (29, 45.0, 64.0, 95.0,
                                                  -400.0)])
    else:  # e1c_8prn (mirrors the e1c_8prn_* reference YAML family)
        sats = tuple(
            SatelliteConfig(prn=p, signal="galileoe1c", cn0_dbhz=34.0,
                            elevation_deg=el, azimuth_deg=az,
                            doppler_hz=dop)
            for p, el, az, dop in [
                (1, 78.0, 15.0, -700.0), (7, 62.0, 75.0, 450.0),
                (12, 55.0, 140.0, 1300.0), (19, 44.0, 190.0, -2100.0),
                (21, 35.0, 230.0, 2800.0), (26, 28.0, 280.0, -3300.0),
                (31, 18.0, 320.0, 3600.0), (33, 9.0, 355.0, -3900.0)])
    return ScenarioConfig(satellites=sats, receiver=ReceiverConfig(),
                          duration_s=60.0)


def gnss_sky(preset: str = "e1c_8prn", elapsed_s: float = 0.0,
             yaml_text: str | None = None) -> dict:
    """Sky-plot snapshot: per-SV elevation/azimuth/C-N0/Doppler at
    elapsed_s (GnssScenario.status + configured azimuths)."""
    from r4w_tpu.gnss.scenario import GnssScenario, load_scenario_yaml

    cfg = (load_scenario_yaml(yaml_text) if yaml_text
           else _sky_preset(preset))
    scen = GnssScenario(cfg)
    status = scen.status(float(elapsed_s))
    az = {s.prn: s.azimuth_deg for s in scen.satellites}
    for s in status:
        s["azimuth_deg"] = float(az.get(s["prn"], 0.0))
        for k, v in list(s.items()):
            if isinstance(v, (np.floating, np.integer)):
                s[k] = float(v)
    return {"elapsed_s": float(elapsed_s), "sats": status}


class _StreamSession:
    """Live UDP IQ → rolling waterfall (the reference GUI's streaming
    view, crates/r4w-gui/src/views/streaming/ + remote_lab.rs role).

    A background thread drains a `net.UdpSource` (loopback bind by
    default) and folds complete FFT frames into a bounded deque of
    power-dB rows; `/api/stream/rows` serves rows incrementally by
    absolute index so any number of browser clients can tail the
    stream. Wire format is the framework's standard
    [seq u32][f32 I/Q...] (net.py), so `net.UdpSink`, the CLI
    `udp-send`, and the reference's sender all feed it directly.
    """

    def __init__(self, port: int = 0, fs: float = 250_000.0,
                 fft_size: int = 256, host: str = "127.0.0.1",
                 max_rows: int = 512):
        import collections

        from r4w_tpu.analysis import Waterfall
        from r4w_tpu.net import UdpConfig, UdpSource

        self.fs = float(fs)
        self.fft = int(fft_size)
        self._src = UdpSource(UdpConfig(host=host, port=int(port),
                                        timeout_s=0.25))
        self._wf = Waterfall(self.fs, self.fft, hop=self.fft)
        self._buf = np.zeros(0, np.complex64)
        self._rows = collections.deque(maxlen=max_rows)
        self._count = 0  # rows ever produced (absolute index space)
        self.error: str | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._src.port

    def _pump(self):
        # FIXED block size: every distinct input length is a fresh jit
        # compile, so the STFT runs on one static shape — warmed once
        # here, reused forever.
        block = 16 * self.fft
        try:
            self._wf.compute(np.zeros(block, np.complex64))
        except Exception as e:  # noqa: BLE001
            self.error = f"{type(e).__name__}: {e}"[:200]
        while not self._stop.is_set():
            try:
                chunk = self._src.recv_batch(128)
                if chunk.size == 0:
                    continue
                # commit self._buf after EVERY block so a mid-buffer
                # exception can't replay already-emitted rows on the
                # next iteration (duplicate spectra to clients)
                self._buf = np.concatenate([self._buf, chunk])
                while self._buf.size >= block:
                    try:
                        rows = self._wf.compute(self._buf[:block])
                    except Exception:
                        # drop the offending block before re-raising:
                        # retrying the same block forever would grow
                        # self._buf without bound while recv_batch
                        # keeps appending (busy-spin + memory leak)
                        self._buf = self._buf[block:]
                        raise
                    with self._lock:
                        for r in rows:
                            self._rows.append(np.round(r, 1))
                            self._count += 1
                    self._buf = self._buf[block:]
            except Exception as e:  # noqa: BLE001 — keep the pump
                # alive and surface the error through /api/stream/rows
                self.error = f"{type(e).__name__}: {e}"[:200]

    def rows_since(self, since: int, max_out: int = 128) -> dict:
        with self._lock:
            total = self._count
            start_abs = total - len(self._rows)
            take_from = max(int(since), start_abs)
            rows = [[round(float(v), 1) for v in self._rows[i - start_abs]]
                    for i in range(take_from, total)][-max_out:]
        return {
            "rows": rows,
            "next": total,
            "fs": self.fs,
            "fft": self.fft,
            "stats": {
                "packets": self._src.packets_received,
                "dropped": self._src.packets_dropped,
                "samples": self._src.samples_received,
                **({"pump_error": self.error} if self.error else {}),
            },
        }

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._src.close()


_stream_lock = threading.Lock()
_stream: _StreamSession | None = None


def stream_start(port: int = 0, fs: float = 250_000.0,
                 fft_size: int = 256) -> dict:
    global _stream
    with _stream_lock:
        if _stream is not None:
            _stream.stop()
        _stream = _StreamSession(port=port, fs=fs, fft_size=fft_size)
        return {"port": _stream.port, "fs": _stream.fs,
                "fft": _stream.fft}


def stream_stop() -> dict:
    global _stream
    with _stream_lock:
        if _stream is None:
            return {"stopped": False}
        _stream.stop()
        _stream = None
        return {"stopped": True}


def stream_tx(name: str = "QPSK", hex_payload: str = "A71B3CD2",
              snr_db: float | None = 20.0, reps: int = 32) -> dict:
    """Send a modulated test burst into the live stream over loopback —
    makes the streaming view drivable with zero external hardware
    (remote-lab self-test)."""
    from r4w_tpu.core.hostio import to_host
    from r4w_tpu.net import UdpSink
    from r4w_tpu.waveforms import create_waveform

    with _stream_lock:
        if _stream is None:
            return {"error": "stream not started"}
        port, fs = _stream.port, _stream.fs
    wf = create_waveform(name, fs)
    if wf is None:
        return {"error": f"unknown waveform '{name}'"}
    payload = bytes.fromhex(hex_payload) if hex_payload else b"\xa7\x1b"
    # host pull through core.hostio (ARCHITECTURE.md §7)
    iq = to_host(wf.modulate(payload)).astype(np.complex64)
    iq = np.tile(iq, max(int(reps), 1))
    if snr_db is not None:
        p = float(np.mean(np.abs(iq) ** 2)) or 1.0
        sigma = np.sqrt(p / (10 ** (float(snr_db) / 10) * 2))
        rng = np.random.default_rng(0)
        iq = iq + sigma * (rng.standard_normal(iq.size)
                           + 1j * rng.standard_normal(iq.size)
                           ).astype(np.complex64)
    sink = UdpSink("127.0.0.1", port)
    try:
        n_pkts = sink.send(iq)
    finally:
        sink.close()
    return {"packets": n_pkts, "samples": int(iq.size)}


def remote_call(spec: dict) -> dict:
    """Forward one command to a `r4w-tpu agent` (agent.py JSON/TCP
    protocol) — the explorer's remote-lab seam. If `target` is the
    literal string "stream", a start_tx is pointed at the live
    waterfall's UDP port so the agent's transmission renders in the
    browser."""
    from r4w_tpu.agent import AgentClient

    host = spec.get("agent_host", "127.0.0.1")
    port = int(spec.get("agent_port", 6000))
    command = spec.get("command", "ping")
    kwargs = {k: v for k, v in spec.items()
              if k not in ("agent_host", "agent_port", "command")}
    if kwargs.get("target") == "stream":
        with _stream_lock:
            if _stream is None:
                return {"response": "error",
                        "message": "start the live stream first"}
            kwargs["target"] = f"127.0.0.1:{_stream.port}"
    try:
        client = AgentClient(host, port, timeout_s=10.0)
    except OSError as e:
        return {"response": "error",
                "message": f"cannot reach agent {host}:{port}: {e}"}
    try:
        return client.call(command, **kwargs)
    finally:
        client.close()


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _local_origin_ok(self) -> bool:
        """Reject cross-origin POSTs: the explorer binds to localhost,
        but any webpage the operator visits can still fire
        fetch('http://127.0.0.1:PORT/api/remote', ...) — and /api/remote
        relays to arbitrary agent hosts (CSRF→SSRF). Browsers always
        attach an Origin header to cross-origin fetches; same-origin
        requests carry the explorer's own host or no Origin (curl)."""
        origin = self.headers.get("Origin")
        if origin is None:
            return True  # non-browser client (curl, tests)
        host = urllib.parse.urlparse(origin).hostname
        return host in ("127.0.0.1", "localhost", "::1")

    def do_POST(self):  # noqa: N802 (stdlib API)
        if not self._local_origin_ok():
            self._json({"error": "cross-origin POST rejected"}, 403)
            return
        parsed = urllib.parse.urlparse(self.path)
        n = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(n).decode() if n else ""
        try:
            if parsed.path == "/api/pipeline":
                from r4w_tpu.pipeline import run_pipeline

                spec = json.loads(body or "{}")
                self._json(run_pipeline(spec.get("nodes", []),
                                        seed=int(spec.get("seed", 0))))
                return
            if parsed.path == "/api/gnss_sky":
                q = urllib.parse.parse_qs(parsed.query)
                self._json(gnss_sky(
                    elapsed_s=float(q.get("t", ["0"])[0]), yaml_text=body))
                return
            if parsed.path == "/api/stream/start":
                spec = json.loads(body or "{}")
                self._json(stream_start(
                    port=int(spec.get("port", 0)),
                    fs=float(spec.get("fs", 250_000.0)),
                    fft_size=int(spec.get("fft", 256))))
                return
            if parsed.path == "/api/stream/stop":
                self._json(stream_stop())
                return
            if parsed.path == "/api/remote":
                # remote-lab passthrough (views/remote_lab.rs role):
                # drive a running `r4w-tpu agent` over its JSON/TCP
                # protocol. `target: "stream"` rewrites a start_tx
                # destination to this explorer's live waterfall port.
                spec = json.loads(body or "{}")
                self._json(remote_call(spec))
                return
            if parsed.path == "/api/stream/tx":
                spec = json.loads(body or "{}")
                self._json(stream_tx(
                    name=spec.get("name", "QPSK"),
                    hex_payload=spec.get("hex", "A71B3CD2"),
                    snr_db=(None if spec.get("snr") in (None, "")
                            else float(spec["snr"])),
                    reps=int(spec.get("reps", 32))))
                return
        except Exception as e:  # surface, don't kill the server
            self._json({"error": f"{type(e).__name__}: {e}"})
            return
        self._json({"error": "not found"}, 404)

    def do_GET(self):  # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/":
            body = _PAGE.replace(
                "%CHANNELS%", json.dumps(list(CHANNEL_MODELS))).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if parsed.path == "/api/waveforms":
            from r4w_tpu.waveforms import list_waveforms

            self._json(list_waveforms())
            return
        if parsed.path == "/api/blocks":
            from r4w_tpu.registry import default_registry

            q = urllib.parse.parse_qs(parsed.query)
            query = q.get("q", [""])[0].lower()
            blocks = default_registry().list()
            if query:
                blocks = [b for b in blocks
                          if query in b.name.lower()
                          or query in b.description.lower()]
            rows = [{"name": b.name, "category": b.category.value,
                     "description": b.description,
                     "params": list(b.params)} for b in blocks]
            if q.get("schema", ["0"])[0] not in ("0", ""):
                # typed param metadata (block_metadata.rs role): the
                # wizard fetches this per-block to render real forms
                reg = default_registry()
                for row in rows:
                    try:
                        row["schema"] = reg.param_schema(row["name"])
                    except Exception as e:  # noqa: BLE001
                        row["schema"] = []
                        row["schema_error"] = f"{type(e).__name__}"
            if q.get("jit", ["0"])[0] not in ("0", ""):
                # Opt-in: first call probes (abstract traces, ~tens of
                # seconds for the full catalog); results are cached on
                # the registry so later calls are instant.
                reg = default_registry()
                for row in rows:
                    status, reason = reg.jit_safety(row["name"])
                    row["jit_safe"] = status
                    if reason:
                        row["jit_reason"] = reason
            self._json(rows)
            return
        if parsed.path == "/api/demo":
            q = urllib.parse.parse_qs(parsed.query)
            try:
                out = run_demo(
                    name=q.get("name", ["BPSK"])[0],
                    hex_payload=q.get("hex", ["A71B3CD2"])[0],
                    channel=q.get("channel", ["none"])[0],
                    snr_db=float(q.get("snr", ["15"])[0]),
                    cfo_hz=float(q.get("cfo_hz", ["0"])[0]),
                    doppler_hz=float(q.get("doppler_hz", ["50"])[0]),
                    tdl_profile=q.get("tdl_profile", ["EPA"])[0],
                    rician_k=float(q.get("rician_k", ["5"])[0]))
            except Exception as e:  # surface, don't kill the server
                out = {"error": f"{type(e).__name__}: {e}"}
            self._json(out)
            return
        if parsed.path == "/api/gnss_sky":
            q = urllib.parse.parse_qs(parsed.query)
            try:
                out = gnss_sky(preset=q.get("preset", ["e1c_8prn"])[0],
                               elapsed_s=float(q.get("t", ["0"])[0]))
            except Exception as e:
                out = {"error": f"{type(e).__name__}: {e}"}
            self._json(out)
            return
        if parsed.path == "/api/stream/rows":
            q = urllib.parse.parse_qs(parsed.query)
            with _stream_lock:
                s = _stream
            if s is None:
                self._json({"error": "stream not started"})
                return
            try:
                since = int(float(q.get("since", ["0"])[0]))
            except ValueError:
                self._json({"error": "since must be a number"})
                return
            self._json(s.rows_since(since))
            return
        self._json({"error": "not found"}, 404)


def serve(host: str = "127.0.0.1", port: int = 8080,
          background: bool = False) -> ThreadingHTTPServer:
    """Start the explorer server (localhost by default — see
    ADVICE r1 on open binds)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    print(f"r4w-tpu explorer on http://{host}:{port}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return httpd


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="r4w-tpu waveform explorer")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)
    serve(args.host, args.port)


if __name__ == "__main__":
    main()
